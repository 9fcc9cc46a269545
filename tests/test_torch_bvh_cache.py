"""The BVH disk cache of `render/bvh.py` (`build_bvh(..., cache=)`), on the
CPU, the cache directory under `tmp_path`: a tree read from the cache
equals a fresh build bit for bit in every field (the dense table
included), with either builder; the second build reads the file and runs
no builder; the LRU keeps BVH_CACHE_KEEP (16) files; scenes under
BVH_CACHE_MIN_TRIS triangles, or with the cache switched off, write
nothing; a truncated file is rebuilt and rewritten; an unusable
directory leaves the build uncached; the key separates the builders and
follows csrc/bvh_build.cpp's bytes; and neither the key nor the directory
is ever the JAX package's for the same meshes."""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from d3d12renderer_tpu.render import bvh as jbvh
from d3d12renderer_tpu_torch.render import bvh, mesh

torch.set_num_threads(1)
CPU = "cpu"


def _scene(i=0):
    return [(mesh.quad(half=5.0 + i), 0),
            (mesh.ico_sphere(1.0, 2).transformed(translate=(0, 1.0, i)), 1),
            (mesh.box((0.5, 0.5, 0.5)).transformed(translate=(2.0, 0.5, 0)),
             2)]


@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    d = tmp_path / "bvh"
    monkeypatch.setenv(bvh.BVH_CACHE_DIR_ENV, str(d))
    monkeypatch.delenv(bvh.BVH_CACHE_ENV, raising=False)
    return d


def _files(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".npz")) \
        if d.exists() else []


def _assert_equal(a, b):
    for f in bvh.BVH_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and torch.equal(x, y), f
    for f in dataclasses.fields(bvh.DenseTris):
        x, y = getattr(a.dense, f.name), getattr(b.dense, f.name)
        assert torch.equal(x, y) or torch.equal(x.isnan(), y.isnan()) and \
            torch.equal(torch.nan_to_num(x), torch.nan_to_num(y)), f.name


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_hit_equals_fresh_build(cache_dir, native):
    if native and shutil.which("g++") is None:
        pytest.skip("the native builder needs g++")
    meshes = _scene()
    fresh = bvh.build_bvh(meshes, device=CPU, native=native, cache=False)
    assert _files(cache_dir) == []
    first = bvh.build_bvh(meshes, device=CPU, native=native, cache=True)
    assert _files(cache_dir) == [bvh.bvh_cache_key(meshes, native) + ".npz"]
    hit = bvh.build_bvh(meshes, device=CPU, native=native, cache=True)
    _assert_equal(first, fresh)
    _assert_equal(hit, fresh)


def test_second_build_reads_the_file(cache_dir, monkeypatch):
    meshes = _scene()
    want = bvh.build_bvh(meshes, device=CPU, native=False, cache=True)

    def refuse(*args):
        raise AssertionError("the builder ran on a cache hit")

    monkeypatch.setattr(bvh, "_build_nodes_native", refuse)
    monkeypatch.setattr(bvh, "_build_nodes_numpy", refuse)
    _assert_equal(bvh.build_bvh(meshes, device=CPU, native=False,
                                cache=True), want)
    with pytest.raises(AssertionError, match="builder ran"):
        bvh.build_bvh(_scene(1), device=CPU, native=False, cache=True)


def test_lru_keeps_the_newest_files(cache_dir):
    keep = bvh.BVH_CACHE_KEEP
    assert keep == 16
    names = []
    for i in range(keep + 2):
        meshes = _scene(i)
        bvh.build_bvh(meshes, device=CPU, native=False, cache=True)
        names.append(bvh.bvh_cache_key(meshes, False) + ".npz")
        # Distinct, increasing mtimes, whatever the file system's clock.
        os.utime(cache_dir / names[-1], (1e9 + i, 1e9 + i))
    assert _files(cache_dir) == sorted(names[2:])
    # A hit refreshes its file's mtime: the oldest is then another's.
    bvh.build_bvh(_scene(2), device=CPU, native=False, cache=True)
    bvh.build_bvh(_scene(keep + 2), device=CPU, native=False, cache=True)
    left = _files(cache_dir)
    assert names[2] in left and names[3] not in left and len(left) == keep


def test_small_scenes_and_the_switch_write_nothing(cache_dir, monkeypatch):
    meshes = _scene()
    tris = sum(len(m.indices) for m, _ in meshes)
    assert tris < bvh.BVH_CACHE_MIN_TRIS == 50_000
    bvh.build_bvh(meshes, device=CPU, native=False)
    assert _files(cache_dir) == []
    monkeypatch.setattr(bvh, "BVH_CACHE_MIN_TRIS", tris)
    monkeypatch.setenv(bvh.BVH_CACHE_ENV, "0")
    bvh.build_bvh(meshes, device=CPU, native=False)
    assert _files(cache_dir) == []
    monkeypatch.delenv(bvh.BVH_CACHE_ENV)
    bvh.build_bvh(meshes, device=CPU, native=False)
    assert len(_files(cache_dir)) == 1


def test_truncated_file_is_rebuilt(cache_dir):
    meshes = _scene()
    want = bvh.build_bvh(meshes, device=CPU, native=False, cache=False)
    bvh.build_bvh(meshes, device=CPU, native=False, cache=True)
    path = cache_dir / _files(cache_dir)[0]
    data = path.read_bytes()
    path.write_bytes(data[:len(data) // 2])
    _assert_equal(bvh.build_bvh(meshes, device=CPU, native=False,
                                cache=True), want)
    assert path.read_bytes() == data
    with np.load(path) as z:
        assert set(z.files) == set(bvh.BVH_FIELDS)


def test_unusable_directory_leaves_the_build_uncached(tmp_path, monkeypatch):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    monkeypatch.setenv(bvh.BVH_CACHE_DIR_ENV, str(blocker / "bvh"))
    meshes = _scene()
    _assert_equal(bvh.build_bvh(meshes, device=CPU, native=False, cache=True),
                  bvh.build_bvh(meshes, device=CPU, native=False,
                                cache=False))


def test_key_separates_builders_and_follows_the_native_source(tmp_path,
                                                             monkeypatch):
    meshes = _scene()
    native, numpy = (bvh.bvh_cache_key(meshes, k) for k in (True, False))
    assert native != numpy
    assert bvh.bvh_cache_key(_scene(1), True) != native
    edited = tmp_path / "bvh_build.cpp"
    edited.write_bytes(bvh.BVH_BUILDER_SOURCE.read_bytes() + b"\n")
    monkeypatch.setattr(bvh, "BVH_BUILDER_SOURCE", edited)
    assert bvh.bvh_cache_key(meshes, True) != native
    assert bvh.bvh_cache_key(meshes, False) == numpy


def test_key_and_directory_never_the_jax_package(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("D3D12TPU_BVH_CACHE_DIR", raising=False)
    monkeypatch.delenv(bvh.BVH_CACHE_DIR_ENV, raising=False)
    meshes = _scene()
    jax_keys = {jbvh._bvh_cache_key(meshes, dense) for dense in (True, False)}
    assert not jax_keys & {bvh.bvh_cache_key(meshes, k)
                           for k in (True, False)}
    assert bvh.bvh_cache_dir() != jbvh._bvh_cache_dir()
    assert bvh.bvh_cache_dir().startswith(str(tmp_path))
    # JAX's variable does not move the port's directory, nor the port's
    # JAX's.
    monkeypatch.setenv("D3D12TPU_BVH_CACHE_DIR", str(tmp_path / "jax"))
    assert bvh.bvh_cache_dir() != jbvh._bvh_cache_dir()
    monkeypatch.setenv(bvh.BVH_CACHE_DIR_ENV, str(tmp_path / "port"))
    monkeypatch.delenv("D3D12TPU_BVH_CACHE_DIR")
    assert bvh.bvh_cache_dir() != jbvh._bvh_cache_dir()
    assert bvh.BVH_CACHE_DIR_ENV != "D3D12TPU_BVH_CACHE_DIR"
    assert bvh.BVH_CACHE_ENV != "D3D12TPU_BVH_CACHE"
