"""The port's nvcc build keys (CPU, no nvcc needed): a library's name holds a
hash of its source, of the headers beside it and of its flags, so an edit to
a shared header rebuilds every source that may include it, and a source from
another directory never takes the package's library."""

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
    for name in ("packed_attention", "packed_attention_bwd", "dense_raster", "zbuffer_resolve"):
        assert (cuda_build.CSRC / f"{name}.cu").exists()
        assert cuda_build._library(name).name.startswith(f"lib{name}-")
