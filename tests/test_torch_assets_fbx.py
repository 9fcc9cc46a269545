"""The port's asset import (`assets/loaders.py`, `native.py`, `fbx.py`,
`async_loader.py`) against the JAX package's, on the CPU: the same FBX
files read by both packages to equal arrays, either package's writer read
by the other's reader, the ASCII document of tests/test_fbx_skin_anim.py,
the OBJ / MTL / PLY loaders and the mesh post-processing, the native mesh
helpers (the port's C++ copy against the JAX package's), and the async
loader's cases of tests/test_async_loading.py.  Host code in numpy on both
sides: arrays must be equal; normals and tangents within 1e-6 (the JAX
package's helpers build with -march=native, whose FMA contraction the
port's -std=c++17 build does not do)."""

import threading
import time

import numpy as np
import pytest

from d3d12renderer_tpu.assets import fbx as jfbx
from d3d12renderer_tpu.assets import loaders as jload
from d3d12renderer_tpu.assets import native as jnative
from d3d12renderer_tpu.render import mesh as jmesh
from d3d12renderer_tpu_torch import convert, entry
from d3d12renderer_tpu_torch.assets import fbx as tfbx
from d3d12renderer_tpu_torch.assets import loaders as tload
from d3d12renderer_tpu_torch.assets import native as tnative
from d3d12renderer_tpu_torch.assets.async_loader import (
    AsyncLoader, LoadState, load_model_async)
from d3d12renderer_tpu_torch.render import mesh as tmesh

from tests.test_assets import MTL, OBJ, PLY_ASCII
from tests.test_fbx_skin_anim import ASCII_DOC

NORMAL_TOL = 1e-6


def _assert_assets_equal(got, want, normal_tol=0.0):
    assert len(got.meshes) == len(want.meshes)
    for a, b in zip(got.meshes, want.meshes):
        np.testing.assert_array_equal(a.positions, b.positions)
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.uvs, b.uvs)
        np.testing.assert_allclose(a.normals, b.normals, atol=normal_tol,
                                   rtol=0)
    assert got.mesh_material == want.mesh_material
    assert [m.__dict__ for m in got.materials] == \
        [m.__dict__ for m in want.materials]
    assert len(got.mesh_skin) == len(want.mesh_skin)
    for a, b in zip(got.mesh_skin, want.mesh_skin):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a.joint_indices, b.joint_indices)
            np.testing.assert_array_equal(a.joint_weights, b.joint_weights)
    assert len(got.skeletons) == len(want.skeletons)
    for a, b in zip(got.skeletons, want.skeletons):
        assert a.names == b.names and a.parents == b.parents
        np.testing.assert_array_equal(a.bind_local_pos, b.bind_local_pos)
        np.testing.assert_array_equal(a.bind_local_rot, b.bind_local_rot)
    assert len(got.animations) == len(want.animations)
    for a, b in zip(got.animations, want.animations):
        for k in ("positions", "rotations", "scales"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
        assert (a.duration, a.looping, a.name) == (b.duration, b.looping,
                                                   b.name)


@pytest.fixture(scope="module")
def character():
    """The generated character's mesh, clusters and clip tracks, coarse."""
    points, tris, clusters = entry._character_mesh(
        entry.CHARACTER_COARSE_GRID)
    rot, pos = entry._character_tracks()
    return points, tris, clusters, rot, pos


def test_jax_written_file_reads_alike(tmp_path, character):
    """A skinned, animated file written by the JAX package's writer: both
    readers give equal arrays (the skeleton's 19 joints, the skin expanded
    to the fan-triangulated corners, the clip resampled to 61 keys)."""
    points, tris, clusters, rot, _ = character
    path = str(tmp_path / "jax.fbx")
    jfbx.write_fbx_skinned(path, points, tris, entry.CHARACTER_JOINTS,
                           clusters, rot, fps=entry.CHARACTER_FPS)
    got, want = tfbx.load_fbx(path), jfbx.load_fbx(path)
    _assert_assets_equal(got, want, NORMAL_TOL)
    assert len(got.skeletons[0].names) == 19
    assert got.animations[0].positions.shape == (19, 61, 3)


def test_port_writer_reads_in_jax(tmp_path, character):
    """The port's writer: without translation tracks its file is the JAX
    writer's byte for byte; with the root's translation track (the
    character's clip) JAX's reader loads it to the port's asset, the root
    track animated."""
    points, tris, clusters, rot, pos = character
    a, b = str(tmp_path / "port.fbx"), str(tmp_path / "jax.fbx")
    tfbx.write_fbx_skinned(a, points, tris, entry.CHARACTER_JOINTS, clusters,
                           rot, fps=entry.CHARACTER_FPS)
    jfbx.write_fbx_skinned(b, points, tris, entry.CHARACTER_JOINTS, clusters,
                           rot, fps=entry.CHARACTER_FPS)
    assert open(a, "rb").read() == open(b, "rb").read()
    path = str(tmp_path / "character.fbx")
    entry.write_character(path, coarse=True)
    got, want = tfbx.load_fbx(path), jfbx.load_fbx(path)
    _assert_assets_equal(got, want, NORMAL_TOL)
    root = got.animations[0].positions[0]
    assert np.ptp(root[:, 1]) > 0.05 and np.allclose(root[0], root[-1],
                                                     atol=1e-6)


def test_geometry_writer_and_quads(tmp_path):
    """`write_fbx_geometry` with normal and UV layers, read by both."""
    src = jmesh.ico_sphere(1.0, 1)
    path = str(tmp_path / "mesh.fbx")
    tfbx.write_fbx_geometry(path, src.positions, src.indices,
                            normals=src.normals, uvs=src.uvs)
    _assert_assets_equal(tfbx.load_fbx(path), jfbx.load_fbx(path))
    root, version = tfbx.parse_fbx(open(path, "rb").read())
    assert version == 7400 and root.find("Objects") is not None


def test_ascii_document_parses(tmp_path):
    """tests/test_fbx_skin_anim.py's ASCII document: the same tree and the
    same asset as the JAX reader's."""
    root = tfbx.parse_fbx_ascii(ASCII_DOC)
    geoms = root.find("Objects").find_all("Geometry")
    assert len(geoms) == 1 and len(geoms[0].find("Vertices").properties[0]) \
        == 12
    path = tmp_path / "arm_ascii.fbx"
    path.write_text(ASCII_DOC)
    got = tfbx.load_fbx(str(path))
    _assert_assets_equal(got, jfbx.load_fbx(str(path)), NORMAL_TOL)
    assert got.skeletons[0].names == ["root", "bone"]


@pytest.mark.parametrize("fmt", ["obj", "ply"])
def test_mesh_loaders_match_jax(tmp_path, fmt):
    """OBJ with its MTL (materials, fan triangulation) and ASCII PLY
    (generated normals) through both packages' `load_model`."""
    (tmp_path / "quad.obj").write_text(OBJ)
    (tmp_path / "test.mtl").write_text(MTL)
    (tmp_path / "quad.ply").write_text(PLY_ASCII)
    path = str(tmp_path / f"quad.{fmt}")
    _assert_assets_equal(tload.load_model(path), jload.load_model(path),
                         NORMAL_TOL)
    assert tload.load_mtl(str(tmp_path / "test.mtl"))["red"].__dict__ == \
        jload.load_mtl(str(tmp_path / "test.mtl"))["red"].__dict__


def test_mesh_postprocessing_matches_jax():
    """`generate_normals`, `generate_tangents` and `weld_mesh` on a welded
    sphere duplicated twice (every vertex has a twin)."""
    s = tmesh.ico_sphere(1.0, 2)
    two = tmesh.merge([s, s])
    js = jmesh.ico_sphere(1.0, 2)
    jtwo = jmesh.merge([js, js])
    np.testing.assert_allclose(tload.generate_normals(two).normals,
                               jload.generate_normals(jtwo).normals,
                               atol=NORMAL_TOL, rtol=0)
    np.testing.assert_array_equal(tload.generate_tangents(two),
                                  jload.generate_tangents(jtwo))
    a, b = tload.weld_mesh(two), jload.weld_mesh(jtwo)
    for k in ("positions", "normals", "uvs", "indices"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    assert len(a.positions) == len(s.positions)


def test_native_helpers_match_jax():
    """The port's C++ copy (`csrc/mesh_ops.cpp`) against the JAX package's
    native library and against the port's numpy route."""
    assert tnative.native_available() and jnative.native_available()
    rng = np.random.default_rng(0)
    pos = rng.normal(size=(500, 3)).astype(np.float32)
    dup = np.concatenate([pos, pos[:100] + 1e-7])
    u1, r1 = tnative.weld_remap(dup, 1e-4)
    u2, r2 = jnative.weld_remap(dup, 1e-4)
    assert u1 == u2 == 500 and np.array_equal(r1, r2)
    idx = rng.integers(0, 500, size=(300, 3)).astype(np.int32)
    n1 = tnative.compute_normals(pos, idx)
    np.testing.assert_allclose(n1, jnative.compute_normals(pos, idx),
                               atol=NORMAL_TOL, rtol=0)
    lines = [f"v {x:.5f} {y:.5f} {z:.5f}" for x, y, z in pos]
    lines += [f"f {a + 1} {b + 1} {c + 1} {a + 1}" for a, b, c in idx[:50]]
    text = "\n".join(lines) + "\n"
    for a, b in zip(tnative.parse_obj_geometry(text),
                    jnative.parse_obj_geometry(text)):
        np.testing.assert_array_equal(a, b)
    # The numpy routes (no library): the port's against JAX's.
    saved = [(mod, mod._lib, mod._tried) for mod in (tnative, jnative)]
    for mod in (tnative, jnative):
        mod._lib, mod._tried = None, True
    try:
        np.testing.assert_allclose(tnative.compute_normals(pos, idx), n1,
                                   atol=1e-5)
        np.testing.assert_array_equal(tnative.compute_normals(pos, idx),
                                      jnative.compute_normals(pos, idx))
        for a, b in zip(tnative.parse_obj_geometry(text),
                        jnative.parse_obj_geometry(text)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(tnative.weld_remap(dup, 1e-4),
                        jnative.weld_remap(dup, 1e-4)):
            np.testing.assert_array_equal(a, b)
    finally:
        for mod, lib, tried in saved:
            mod._lib, mod._tried = lib, tried


def test_model_asset_from_jax_arrays(tmp_path):
    """`convert.model_asset_from_numpy` turns JAX's in-memory asset into
    the port's, equal array for array."""
    path = str(tmp_path / "character.fbx")
    entry.write_character(path, coarse=True)
    want = jfbx.load_fbx(path)
    got = convert.model_asset_from_numpy(want)
    assert isinstance(got, tload.ModelAsset)
    _assert_assets_equal(got, want)


# The async loader: tests/test_async_loading.py's cases on the port.

def test_async_load_states_and_result():
    loader = AsyncLoader(workers=2)
    gate = threading.Event()
    h = loader.submit("a.bin", lambda p: (gate.wait(5.0), {"data": 42})[1])
    assert h.state == LoadState.LOADING and h.result is None
    gate.set()
    assert h.wait(5.0)["data"] == 42 and h.state == LoadState.LOADED
    loader.shutdown()


def test_async_failed_load_records_error():
    loader = AsyncLoader(workers=1)

    def bad(path):
        raise ValueError("corrupt")

    h = loader.submit("bad.bin", bad)
    with pytest.raises(RuntimeError):
        h.wait(5.0)
    assert h.state == LoadState.FAILED and isinstance(h.error, ValueError)
    loader.shutdown()


def test_async_concurrency_dedup_and_chaining():
    loader = AsyncLoader(workers=4)
    active, peak, lock = [], [], threading.Lock()

    def tracked(path):
        with lock:
            active.append(path)
            peak.append(len(active))
        time.sleep(0.05)
        with lock:
            active.remove(path)
        return path

    handles = loader.submit_many([f"m{i}" for i in range(4)], tracked)
    assert sorted(loader.wait_all(handles, 10.0)) == [f"m{i}" for i in
                                                      range(4)]
    assert max(peak) > 1
    assert loader.submit("m0", tracked) is handles[0]
    chained, seen = threading.Event(), {}

    def done(handle):
        seen["state"] = handle.state
        chained.set()

    loader.submit("x", lambda p: 7, on_done=done)
    assert chained.wait(5.0) and seen["state"] == LoadState.LOADED
    loader.shutdown()


def test_async_model_load(tmp_path):
    """`load_model_async` of an OBJ through the binary cache."""
    obj = tmp_path / "tri.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nvn 0 0 1\nf 1//1 2//1 3//1\n")
    asset = load_model_async(str(obj)).wait(30.0)
    assert len(asset.meshes) == 1 and asset.meshes[0].positions.shape[0] >= 3
