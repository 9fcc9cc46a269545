"""The port's editor (`utils/undo.py`, `core/camera_controller.py`,
`scene/viewer.py`, tools/torch_scene_viewer.py and
tools/torch_inspect_scene.py) against the JAX package on the CPU:

- the undo ring against JAX's on one script of pushes, undos and redos;
- the orbit and fly controllers' cameras within CAMERA_TOL of JAX's;
- the viewer's panels (the G-buffer's normals, depth and object id, and
  HBAO) of the demo scene at 32x32 against JAX's `render_gbuffer` + `hbao`
  under `jax.jit`, at tests/test_torch_pipeline.py's G-buffer bounds
  (EDGE_SHARE, FIELD_TOL) and its frame bounds for AO (PIXEL_TOL on SHARE
  of the pixels, mean below MEAN_TOL);
- the served loop on 127.0.0.1 at a free port, size 32, spp 1, through
  tests/test_scene_viewer.py's session (with fewer play frames; a refused
  edit answers 409 where JAX's tool answers 500 for every failure);
- the static page's images, entities and physics line
  (tests/test_scene_viewer.py's first test), the inspector's printout equal
  to tools/inspect_scene.py's, and PNGs of the stdlib encoder decoded back.
"""

import math
import os
import re
import struct
import subprocess
import sys
import threading
import urllib.error
import zlib
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from d3d12renderer_tpu.core import camera_controller as jcc
from d3d12renderer_tpu.render import camera as jcam
from d3d12renderer_tpu.render import post as jpost
from d3d12renderer_tpu.render.gbuffer import render_gbuffer as jgbuffer
from d3d12renderer_tpu.scene import components as JC
from d3d12renderer_tpu.scene.scene import Scene as JScene
from d3d12renderer_tpu.utils.undo import UndoStack as JUndo
from d3d12renderer_tpu_torch.core import camera_controller as tcc
from d3d12renderer_tpu_torch.scene import viewer
from d3d12renderer_tpu_torch.utils.undo import UndoStack as TUndo

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
CAMERA_TOL = 1e-6
EDGE_SHARE = 2e-3
FIELD_TOL = 1e-4
PIXEL_TOL = 1e-3
SHARE = 0.99
MEAN_TOL = 1e-4
SIZE = 32


def _undo_script(stack_cls):
    """A log of (call, result, state, undo_name, redo_name, verify)."""
    doc = {"v": 0}

    def toggle(old):
        cur = doc["v"]
        doc["v"] = old
        return cur

    st = stack_cls(capacity=3)
    log = []

    def push(v):
        old = doc["v"]
        doc["v"] = v
        st.push(f"set {v}", old, toggle)
        return None

    for op, arg in (("push", 1), ("push", 2), ("undo", None),
                    ("undo", None), ("undo", None), ("redo", None),
                    ("push", 5), ("redo", None), ("push", 6), ("push", 7),
                    ("push", 8), ("undo", None), ("undo", None),
                    ("undo", None), ("undo", None), ("redo", None),
                    ("redo", None), ("redo", None), ("redo", None)):
        res = push(arg) if op == "push" else getattr(st, op)()
        log.append((op, res, doc["v"], st.undo_name, st.redo_name,
                    st.verify()))
    return log


def test_undo_ring_matches_jax():
    """The same results, states and names at every call; the ring keeps
    its capacity's newest entries."""
    got, want = _undo_script(TUndo), _undo_script(JUndo)
    assert got == want
    assert [r[1] for r in got[11:15]] == ["set 8", "set 7", "set 6", None]


def test_camera_controllers_match_jax():
    for jc, tc in ((jcc.OrbitController(), tcc.OrbitController()),
                   (jcc.FlyController(), tcc.FlyController())):
        for step in range(4):
            if isinstance(jc, jcc.OrbitController):
                for c in (jc, tc):
                    c.rotate(0.7 * step - 0.4, 0.9 - 0.5 * step)
                    c.zoom(0.6 + 0.3 * step)
                    c.pan(0.05 * step, -0.03)
            else:
                for c in (jc, tc):
                    c.look(0.5 - 0.3 * step, 0.8 * step - 1.0)
                    c.move(0.1, forward=1.0, right=-0.5 * step, up=0.25)
            want = jc.camera(aspect=1.5, v_fov=math.radians(55))
            got = tc.camera(device="cpu", aspect=1.5, v_fov=math.radians(55))
            np.testing.assert_allclose(got.position.numpy(),
                                       np.asarray(want.position), rtol=0,
                                       atol=CAMERA_TOL)
            np.testing.assert_allclose(got.rotation.numpy(),
                                       np.asarray(want.rotation), rtol=0,
                                       atol=CAMERA_TOL)
            assert (got.aspect, got.v_fov) == (want.aspect, want.v_fov)
        for f in ("target", "position", "yaw", "pitch", "distance"):
            if hasattr(jc, f):
                np.testing.assert_allclose(getattr(tc, f), getattr(jc, f),
                                           rtol=0, atol=CAMERA_TOL)


def _jax_scene(doc):
    s = JScene()
    for p in doc["planes"]:
        s.add_static_plane(p[:3], p[3], p[4], p[5])
    for ed in doc["entities"]:
        e = s.create_entity(ed["name"])
        for kind, data in ed["components"].items():
            for d in (data if kind in ("collider", "joint") else [data]):
                e.add_component(JC.from_plain(kind, dict(d)))
    return s


def test_viewer_panels_match_jax():
    """The static page's first view: the same orbit, the panels of both
    packages' render scenes at the compiled body poses."""
    ts = viewer.build_demo_scene()
    js = _jax_scene(ts.to_document())
    tarch, tstate, tmap = ts.compile_physics(device="cpu")
    trs = ts.build_render_scene(tstate, tmap, device="cpu")
    _, jstate, jmap = js.compile_physics()
    jrs = js.build_render_scene(body_state=jstate, mapping=jmap)
    center, radius = viewer.scene_center_radius(trs)
    phi = viewer.STATIC_PHI
    eye = center + np.array([math.cos(phi), math.sin(phi), 0.0]) * radius
    jc = jcam.look_at(eye=tuple(eye), target=tuple(center + [0, 0.5, 0]),
                      aspect=1.0, v_fov=math.radians(50))
    tc = viewer.orbit_camera(center, radius, 0.0, phi, device="cpu")
    np.testing.assert_allclose(tc.rotation.numpy(), np.asarray(jc.rotation),
                               rtol=0, atol=CAMERA_TOL)
    got = viewer.aux_buffers(trs, tc, SIZE)

    def panels(rs, cam):
        gb = jgbuffer(rs, cam, SIZE, SIZE)
        return (gb.normal, gb.depth, gb.object_id,
                jpost.hbao(gb.view_pos, gb.view_normal))

    jn, jd, jo, jao = (np.asarray(x) for x in jax.jit(panels)(jrs, jc))
    hit, whit = np.isfinite(got["depth"]), np.isfinite(jd)
    assert 0.2 < whit.mean() < 1.0
    same = hit & whit & (got["object id"] == jo)
    assert (~same & (hit | whit)).mean() <= EDGE_SHARE
    for g, w in ((got["normals"], jn), (got["depth"], jd)):
        err = np.abs(g[same] - w[same]).reshape(int(same.sum()), -1)
        bad = (err > FIELD_TOL * np.maximum(1.0, np.abs(
            w[same]).reshape(err.shape))).any(-1)
        assert bad.mean() <= EDGE_SHARE
    err = np.abs(got["AO"] - jao)
    assert (err <= PIXEL_TOL).mean() >= SHARE and err.mean() < MEAN_TOL
    for k, v in got.items():
        img = viewer.aux_u8(k, v)
        assert img.dtype == np.uint8 and img.shape[:2] == (SIZE, SIZE)


@pytest.fixture()
def server():
    editor = viewer.Editor(viewer.build_demo_scene(), SIZE, 1, "cpu")
    httpd = viewer.make_server(editor, 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield viewer.Client(f"http://127.0.0.1:{httpd.server_address[1]}",
                        timeout=120)
    httpd.shutdown()
    httpd.server_close()
    thread.join()


def test_served_loop(server):
    """tests/test_scene_viewer.py:40 onward, on the port's server."""
    get, post = server.get, server.post
    q = f"size={SIZE}&spp=1"

    def entity(name):
        return next(e for e in server.get_json("/entities")
                    if e["name"] == name)

    assert b"scene viewer" in get("/")
    png = get(f"/render?{q}&theta=0.3&phi=0.5")
    assert png[:4] == b"\x89PNG"
    png2 = get(f"/render?{q}&theta=2.1&phi=0.5")
    assert png2[:4] == b"\x89PNG" and png2 != png
    for kind in ("normals", "depth", "ao"):
        assert get(f"/render?size={SIZE}&kind={kind}")[:4] == b"\x89PNG"
    with pytest.raises(urllib.error.HTTPError) as e:
        get(f"/render?size={SIZE}&kind=albedo")
    assert e.value.code == 500
    with pytest.raises(urllib.error.HTTPError) as e:
        get("/nothing")
    assert e.value.code == 404

    red = entity("RedSphere")
    assert red["position"][0] == pytest.approx(0.0)
    post("/edit", {"id": red["id"], "position": [3.0, 0.8, 0.0]})
    assert entity("RedSphere")["position"][0] == pytest.approx(3.0)
    assert get(f"/render?{q}")[:4] == b"\x89PNG"
    assert post("/undo")["undone"] == "edit RedSphere"
    assert entity("RedSphere")["position"][0] == pytest.approx(0.0)
    assert post("/redo")["redone"] == "edit RedSphere"
    assert entity("RedSphere")["position"][0] == pytest.approx(3.0)
    info = server.get_json("/info")
    assert info["radius"] > 0 and info["undo"] == "edit RedSphere"
    post("/undo")

    # Play: the clone falls, the editor scene keeps its transforms.
    assert post("/play")["mode"] == "play"
    first = get(f"/render?{q}")
    for _ in range(3):
        assert get(f"/render?{q}")[:4] == b"\x89PNG"
    later = get(f"/render?{q}")
    assert later != first, "play frames should show motion"
    frames = server.get_json("/info")["frames"]
    assert frames == 5
    ph = server.get_json("/physics")
    assert ph["frames"] == 5
    assert ph["bodies"][str(red["id"])]["position"][1] < 2.2
    assert post("/pause")["mode"] == "pause"
    get(f"/render?{q}")
    assert server.get_json("/info")["frames"] == frames
    with pytest.raises(urllib.error.HTTPError) as e:
        post("/edit", {"id": red["id"], "position": [0, 9, 0]})
    assert e.value.code == 409
    assert post("/stop")["mode"] == "edit"
    red2 = entity("RedSphere")
    assert red2["position"][1] == pytest.approx(2.2)
    with pytest.raises(urllib.error.HTTPError) as e:
        get("/physics")
    assert e.value.code == 409

    # A material edit with undo.
    assert red2["detail"]["material"]["albedo"][0] == pytest.approx(0.75)
    post("/edit", {"id": red2["id"], "component": "material",
                   "index": None, "fields": {"albedo": [0.1, 0.9, 0.1],
                                             "roughness": 0.9}})
    assert entity("RedSphere")["detail"]["material"]["albedo"][1] == \
        pytest.approx(0.9)
    assert post("/undo")["undone"] == "edit RedSphere"
    assert entity("RedSphere")["detail"]["material"]["albedo"][0] == \
        pytest.approx(0.75)

    # The paddle's motor retargeted during play.
    paddle = entity("Paddle")
    assert paddle["detail"]["joint"][0]["motor_target"] == 0.0
    assert post("/play")["mode"] == "play"
    get(f"/render?{q}")
    w0 = server.get_json("/physics")["bodies"][str(paddle["id"])][
        "ang_vel"][1]
    assert abs(w0) < 0.5, f"paddle should be still, spins at {w0}"
    post("/edit", {"id": paddle["id"], "component": "joint", "index": 0,
                   "fields": {"motor_target": 6.0}})
    for _ in range(2):
        get(f"/render?{q}")
    w1 = server.get_json("/physics")["bodies"][str(paddle["id"])][
        "ang_vel"][1]
    assert abs(w1) > 2.0, f"motor retarget must spin the paddle, got {w1}"
    post("/stop")
    assert entity("Paddle")["detail"]["joint"][0]["motor_target"] == 6.0
    assert post("/undo")["undone"] == "edit Paddle"
    assert entity("Paddle")["detail"]["joint"][0]["motor_target"] == 0.0


def test_static_page_and_cli(tmp_path, capsys):
    """tests/test_scene_viewer.py's page checks through the port's CLI
    (2 views + 4 panels), and the inspector's printout equal to
    tools/inspect_scene.py's."""
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import torch_inspect_scene
        import torch_scene_viewer
    finally:
        sys.path.remove(str(REPO / "tools"))
    yml = str(tmp_path / "scene.yaml")
    viewer.build_demo_scene().save_yaml(yml)
    out = str(tmp_path / "scene.html")
    torch_scene_viewer.main([yml, "--out", out, "--size", "16", "--views",
                             "2", "--spp", "1", "--device", "cpu"])
    doc = open(out).read()
    assert len(re.findall(r"base64,([A-Za-z0-9+/=]+)\"", doc)) == 6
    for name in ("RedSphere", "GroundVis", "Paddle", "Sun"):
        assert name in doc
    assert "collider: sphere" in doc and "collider: box" in doc
    assert "5 bodies" in doc and "5 colliders" in doc and "1 hinge" in doc
    capsys.readouterr()
    torch_inspect_scene.main([yml, "--device", "cpu"])
    got = capsys.readouterr().out
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    want = subprocess.run(
        [sys.executable, str(REPO / "tools" / "inspect_scene.py"), yml],
        capture_output=True, text=True, check=True, env=env,
        cwd=REPO).stdout
    assert got == want and "5 bodies" in got


def _decode_png(data: bytes):
    """Chunks, then the filter-0 rows of one IDAT stream."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        chunks[tag] = body
        pos += 12 + n
    w, h, depth, ctype, _, _, _ = struct.unpack(">IIBBBBB", chunks[b"IHDR"])
    ch = {0: 1, 2: 3, 6: 4}[ctype]
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = rows.reshape(h, 1 + w * ch)
    assert depth == 8 and not rows[:, 0].any() and b"IEND" in chunks
    return rows[:, 1:].reshape((h, w) if ch == 1 else (h, w, ch))


@pytest.mark.parametrize("shape", [(5, 7), (6, 3, 3), (4, 9, 4), (2, 2, 1)])
def test_png_round_trip(shape):
    img = np.random.default_rng(1).integers(0, 256, shape, np.uint8)
    data = viewer.png_bytes(img)
    np.testing.assert_array_equal(_decode_png(data), img.reshape(
        shape[:2] if shape[-1] == 1 else shape))
    from PIL import Image
    import io

    back = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(back, img.reshape(
        shape[:2] if shape[-1] == 1 else shape))
    assert viewer.png_b64(img) == __import__("base64").b64encode(
        data).decode()
    with pytest.raises(ValueError):
        viewer.png_bytes(np.zeros((2, 2, 2), np.uint8))
