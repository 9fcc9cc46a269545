"""Scene viewer — the web half of the editor substitute (counterpart of
``tools/scene_viewer.py``), on a device.

Reference: the editor's hierarchy/inspector/aux-texture panels and play-mode
loop (src/editor/editor.cpp:247, editor.h:45-51).  Two modes:

Static (`write_static`): one self-contained HTML file with the entity tree
and all components, the physics compilation line, orbiting path-traced
views, and the intermediate render targets (normals / depth / object id /
AO) the reference exposes as panels.

Live (`serve`): a local HTTP loop — orbit/zoom the camera in the browser
(drag + wheel -> re-render request -> PNG response), inspect and edit
components; every edit goes through utils/undo.UndoStack, so Undo/Redo work
like the reference's toggle-blob ring (src/editor/undo_stack.h:6-40); play
/ pause / stop step a clone of the scene with the physics on the device.

Settings are arguments (the CLI is tools/torch_scene_viewer.py), so tests
and scripts call these functions directly.  PNGs are encoded with zlib and
struct from the standard library.  Scenes of more than 1,024 triangles take
the BVH ray kernel on the card, smaller ones the brute-force kernel; play
mode's contact and joint rows take the colored-solver kernel (or the fused
substep where the archetype is in its family).
"""

from __future__ import annotations

import base64
import dataclasses
import html
import json
import math
import struct
import threading
import time
import traceback
import urllib.error
import urllib.request
import zlib
from typing import Optional

import numpy as np
import torch

from . import components as C
from .scene import Scene
from ..core.log import log_error
from ..utils.undo import UndoStack

# Static views: the orbit's elevation (JAX tool: asin(0.5 / sqrt(1.25))).
STATIC_PHI = math.asin(0.5 / math.sqrt(1.25))
RECURSION_DEPTH = 2
PLAY_DT = 1.0 / 60.0
# `editor_session`'s play renders take one sample, as
# tests/test_scene_viewer.py's session renders every frame.
PLAY_SPP = 1


class EditRefused(Exception):
    """An edit the editor refuses in its current mode (HTTP 409)."""


# ---------------------------------------------------------------------------
# Images
# ---------------------------------------------------------------------------

def png_bytes(arr_u8) -> bytes:
    """An 8-bit gray (H, W), RGB (H, W, 3) or RGBA (H, W, 4) array as PNG:
    filter 0 on every row, one zlib stream."""
    a = np.ascontiguousarray(np.asarray(arr_u8, np.uint8))
    if a.ndim == 3 and a.shape[2] == 1:
        a = a[..., 0]
    if a.ndim == 2:
        color_type = 0
    elif a.ndim == 3 and a.shape[2] in (3, 4):
        color_type = 2 if a.shape[2] == 3 else 6
    else:
        raise ValueError(f"cannot encode an array of shape {a.shape}")
    h, w = a.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), a.reshape(h, -1)], 1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type,
                                         0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def png_b64(arr_u8) -> str:
    return base64.b64encode(png_bytes(arr_u8)).decode()


def gray_u8(x):
    x = np.asarray(x, np.float64)
    finite = x[np.isfinite(x)]
    lo = finite.min() if finite.size else 0.0
    hi = finite.max() if finite.size else 1.0
    x = np.nan_to_num(x, nan=hi, posinf=hi, neginf=lo)
    n = (x - lo) / max(hi - lo, 1e-9)
    return (np.clip(n, 0, 1) * 255).astype(np.uint8)


def normals_u8(normal):
    return ((np.asarray(normal) * 0.5 + 0.5) * 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Scene, camera, renders
# ---------------------------------------------------------------------------

def build_demo_scene() -> Scene:
    """Showcase-style multi-object scene through the ECS path
    (tools/scene_viewer.py:99-157)."""
    s = Scene()
    s.add_static_plane((0, 1, 0), 0.0)
    # Dynamic bodies start above their rest height so play mode (clone +
    # physics step per frame) visibly drops them; the torus is static.
    specs = [
        ("RedSphere", "sphere", {"radius": 0.8}, (0.0, 2.2, 0.0),
         dict(albedo=(0.75, 0.15, 0.12), roughness=0.35),
         C.Collider(shape="sphere", size=(0.8,), restitution=0.4)),
        ("MetalSphere", "sphere", {"radius": 0.6}, (-1.9, 1.4, 0.7),
         dict(albedo=(0.95, 0.93, 0.88), roughness=0.12, metallic=1.0),
         C.Collider(shape="sphere", size=(0.6,))),
        ("BlueBox", "box", {"half_extents": (0.55, 0.55, 0.55)},
         (1.9, 1.3, -0.4), dict(albedo=(0.15, 0.3, 0.75), roughness=0.5),
         C.Collider(shape="box", size=(0.55, 0.55, 0.55))),
        ("GreenTorus", "torus", {"major": 0.8, "minor": 0.25},
         (0.7, 0.26, 1.9), dict(albedo=(0.2, 0.7, 0.3), roughness=0.4),
         None),
    ]
    for name, prim, params, pos, mat, col in specs:
        e = s.create_entity(name)
        e.add_component(C.Transform(position=pos))
        e.add_component(C.Mesh(primitive=prim, params=params))
        e.add_component(C.Material(**mat))
        if col is not None:
            e.add_component(C.RigidBody())
            e.add_component(col)
    ground = s.create_entity("GroundVis")
    ground.add_component(C.Transform())
    ground.add_component(C.Mesh(primitive="quad", params={"half": 12.0}))
    ground.add_component(C.Material(albedo=(0.45, 0.45, 0.45), roughness=0.7))
    # Motorized spinner: kinematic post + hinged paddle with a velocity
    # motor — the constraint-editing demo (reference: the inspector edits
    # constraint motors live, src/editor/editor.cpp).
    post = s.create_entity("Post")
    post.add_component(C.Transform(position=(-2.5, 0.6, -2.0)))
    post.add_component(C.Mesh(primitive="box",
                              params={"half_extents": (0.1, 0.6, 0.1)}))
    post.add_component(C.Material(albedo=(0.4, 0.35, 0.3)))
    post.add_component(C.RigidBody(kinematic=True))
    post.add_component(C.Collider(shape="box", size=(0.1, 0.6, 0.1)))
    paddle = s.create_entity("Paddle")
    paddle.add_component(C.Transform(position=(-2.5, 1.35, -2.0)))
    paddle.add_component(C.Mesh(primitive="box",
                                params={"half_extents": (0.5, 0.05, 0.12)}))
    paddle.add_component(C.Material(albedo=(0.8, 0.6, 0.2), roughness=0.3))
    paddle.add_component(C.RigidBody(gravity_factor=0.0, linear_damping=0.0,
                                     angular_damping=0.0))
    paddle.add_component(C.Collider(shape="box", size=(0.5, 0.05, 0.12),
                                    density=200.0))
    paddle.add_component(C.Joint(kind="hinge", other=post.id,
                                 anchor=(-2.5, 1.35, -2.0),
                                 axis=(0.0, 1.0, 0.0),
                                 motor_type="velocity", motor_target=0.0,
                                 motor_max=50.0))
    sun = s.create_entity("Sun")
    sun.add_component(C.DirectionalLight())
    return s


def orbit_camera(center, radius, theta, phi, aspect=1.0, device="cuda"):
    from ..render.camera import look_at

    phi = max(-1.45, min(1.45, phi))
    eye = center + np.array([
        math.cos(phi) * math.cos(theta), math.sin(phi),
        math.cos(phi) * math.sin(theta),
    ]) * radius
    return look_at(eye=tuple(eye), target=tuple(center + [0, 0.5, 0]),
                   aspect=aspect, v_fov=math.radians(50), device=device)


def scene_center_radius(rscene, orbit_radius: Optional[float] = None):
    """The valid triangles' mean first vertex and 2.2x their farthest
    distance from it (or `orbit_radius`)."""
    bvh = rscene.bvh
    tv = bvh.tri_v0[bvh.tri_valid].detach().cpu().numpy()
    center = tv.mean(0) if len(tv) else np.zeros(3)
    radius = orbit_radius or (
        float(2.2 * np.linalg.norm(tv - center, axis=-1).max())
        if len(tv) else 10.0)
    return center, radius


def beauty(rscene, cam, size: int, spp: int, seed: int = 0):
    """(size, size, 3) uint8 on the host: the path tracer at recursion
    depth 2, `spp` samples from a generator seeded `seed`, tonemapped."""
    from ..render.pathtracer import (PathTracerSettings, Sampler, render,
                                     to_srgb_u8)

    dev = cam.position.device
    img, _ = render(rscene, cam, size, size,
                    PathTracerSettings(recursion_depth=RECURSION_DEPTH),
                    spp=spp, sampler=Sampler(
                        torch.Generator(device=dev).manual_seed(seed)))
    return to_srgb_u8(img).cpu().numpy()


def aux_buffers(rscene, cam, size: int) -> dict:
    """The editor's render-target panels as float arrays on the host:
    the G-buffer's world normals, depth and object id, and HBAO."""
    from ..render import post
    from ..render.gbuffer import render_gbuffer

    gb = render_gbuffer(rscene, cam, size, size)
    ao = post.hbao(gb.view_pos, gb.view_normal)
    return {"normals": gb.normal.cpu().numpy(),
            "depth": gb.depth.cpu().numpy(),
            "object id": gb.object_id.cpu().numpy(),
            "AO": ao.cpu().numpy()}


def aux_u8(name: str, x):
    return normals_u8(x) if name == "normals" else gray_u8(x)


# ---------------------------------------------------------------------------
# Live server
# ---------------------------------------------------------------------------

VIEWER_HTML = """<!doctype html><html><head><meta charset="utf-8">
<title>scene viewer</title><style>
body { font: 13px/1.5 system-ui, sans-serif; margin: 0; display: flex;
       background: #16181d; color: #d7dae0; height: 100vh; }
#left { flex: 1; display: flex; flex-direction: column; align-items: center;
        justify-content: center; }
#view { image-rendering: pixelated; border: 1px solid #333; cursor: grab;
        max-width: 90%; }
#side { width: 360px; overflow-y: auto; padding: 12px; border-left: 1px solid
        #2a2d34; }
button { background: #242832; color: #d7dae0; border: 1px solid #3a3f4b;
         border-radius: 4px; padding: 3px 10px; margin: 2px; cursor: pointer; }
button:hover { background: #2e3340; }
input[type=number] { width: 62px; background: #1b1e24; color: #d7dae0;
         border: 1px solid #3a3f4b; border-radius: 3px; }
select { background: #1b1e24; color: #d7dae0; border: 1px solid #3a3f4b; }
.ent { border-bottom: 1px solid #2a2d34; padding: 6px 0; }
.ent b { color: #9ecbff; } .comps { color: #8a8f98; font-size: 11px; }
#status { color: #8a8f98; font-size: 11px; margin-top: 6px; }
</style></head><body>
<div id="left"><img id="view" width="512" height="512">
  <div id="status">drag = orbit &middot; wheel = zoom</div></div>
<div id="side">
  <div>
    <button onclick="setMode('play')">&#9654;</button>
    <button onclick="setMode('pause')">&#9208;</button>
    <button onclick="setMode('stop')">&#9209;</button>
    <button onclick="act('undo')">&#8630; Undo</button>
    <button onclick="act('redo')">&#8631; Redo</button>
    target: <select id="kind" onchange="refresh()">
      <option>beauty</option><option>normals</option><option>depth</option>
      <option>ao</option></select>
    spp: <input id="spp" type="number" value="SPP0" min="1" max="64"
                onchange="refresh()">
  </div>
  <div id="ents"></div>
</div>
<script>
let theta = 0.8, phi = 0.45, radius = null, busy = false, dirty = false;
const view = document.getElementById('view');
function url() {
  let u = `/render?theta=${theta}&phi=${phi}` +
      `&kind=${document.getElementById('kind').value}` +
      `&spp=${document.getElementById('spp').value}`;
  if (radius !== null) u += `&radius=${radius}`;
  return u;
}
function refresh() {
  if (busy) { dirty = true; return; }
  busy = true;
  const t0 = performance.now();
  fetch(url()).then(r => r.blob()).then(b => {
    view.src = URL.createObjectURL(b);
    document.getElementById('status').textContent =
      `render ${(performance.now() - t0).toFixed(0)} ms`;
    busy = false;
    if (dirty) { dirty = false; refresh(); }
  }).catch(() => { busy = false; });
}
let drag = null;
view.addEventListener('mousedown', e => { drag = [e.clientX, e.clientY]; });
window.addEventListener('mouseup', () => { drag = null; });
window.addEventListener('mousemove', e => {
  if (!drag) return;
  theta += (e.clientX - drag[0]) * 0.01;
  phi = Math.max(-1.4, Math.min(1.4, phi + (e.clientY - drag[1]) * 0.01));
  drag = [e.clientX, e.clientY];
  refresh();
});
view.addEventListener('wheel', e => {
  e.preventDefault();
  fetch('/info').then(r => r.json()).then(j => {
    if (radius === null) radius = j.radius;
    radius *= Math.exp(e.deltaY * 0.001);
    refresh();
  });
}, { passive: false });
function act(what) {
  fetch('/' + what, { method: 'POST' })
    .then(r => r.json()).then(() => { loadEnts(); refresh(); });
}
let mode = 'edit';
function setMode(what) {
  fetch('/' + what, { method: 'POST' }).then(r => r.json()).then(j => {
    mode = j.mode;
    if (mode === 'play') playLoop(); else refresh();
  });
}
function playLoop() {
  if (mode !== 'play') return;
  if (busy) { setTimeout(playLoop, 30); return; }
  busy = true;
  fetch(url()).then(r => r.blob()).then(b => {
    view.src = URL.createObjectURL(b);
    busy = false;
    setTimeout(playLoop, 10);
  }).catch(() => { busy = false; });
}
function applyEdit(id) {
  const p = ['x', 'y', 'z'].map(a =>
    parseFloat(document.getElementById(`p_${id}_${a}`).value));
  fetch('/edit', { method: 'POST',
    headers: { 'Content-Type': 'application/json' },
    body: JSON.stringify({ id: id, position: p }) })
    .then(r => r.json()).then(() => refresh());
}
// Editable fields per component kind (the inspector's reach: materials,
// constraint motors/limits, lights, body params).
const EDITABLE = {
  material: ['albedo', 'emissive', 'roughness', 'metallic'],
  joint: ['motor_target', 'motor_max', 'limit_min', 'limit_max'],
  point_light: ['color', 'intensity', 'radius'],
  rigid_body: ['gravity_factor', 'linear_damping', 'angular_damping'],
};
function compEditor(e, comp, data, index) {
  const flds = EDITABLE[comp]; if (!flds) return '';
  const tag = (f, i, v) =>
    `<input type="number" step="0.1" value="${(+v).toFixed(2)}"
       data-e="${e.id}" data-c="${comp}" data-i="${index}" data-f="${f}"
       ${i === null ? '' : `data-vec="${i}"`}>`;
  let h = `<div class="comps">${comp}${index !== null ? '[' + index + ']' : ''}`;
  for (const f of flds) {
    const v = data[f];
    if (v === null || v === undefined) continue;
    if (Array.isArray(v)) h += ` ${f} ` + v.map((x, i) => tag(f, i, x)).join('');
    else if (typeof v === 'number') h += ` ${f} ` + tag(f, null, v);
  }
  return h + ` <button onclick="editComp(${e.id},'${comp}',${index})">
    apply</button></div>`;
}
function editComp(id, comp, index) {
  const fields = {};
  document.querySelectorAll(
    `input[data-e="${id}"][data-c="${comp}"][data-i="${index}"]`
  ).forEach(el => {
    const f = el.dataset.f, x = parseFloat(el.value);
    if (el.dataset.vec !== undefined)
      (fields[f] = fields[f] || [])[parseInt(el.dataset.vec)] = x;
    else fields[f] = x;
  });
  fetch('/edit', { method: 'POST',
    headers: { 'Content-Type': 'application/json' },
    body: JSON.stringify({ id: id, component: comp, index: index,
                           fields: fields }) })
    .then(r => r.json()).then(() => refresh());
}
function loadEnts() {
  fetch('/entities').then(r => r.json()).then(es => {
    const box = document.getElementById('ents');
    box.innerHTML = es.map(e => {
      let h = `<div class="ent"><b>${e.name}</b> <span class="comps">#${e.id}
        &middot; ${e.components.join(', ')}</span>`;
      if (e.position) {
        h += '<div>' + ['x', 'y', 'z'].map((a, i) =>
          `${a} <input id="p_${e.id}_${a}" type="number" step="0.1"
             value="${e.position[i].toFixed(2)}">`).join(' ') +
          ` <button onclick="applyEdit(${e.id})">move</button></div>`;
      }
      for (const comp in (e.detail || {})) {
        const d = e.detail[comp];
        if (Array.isArray(d)) d.forEach((c, i) => h += compEditor(e, comp, c, i));
        else h += compEditor(e, comp, d, null);
      }
      h += '</div>';
      return h;
    }).join('');
  });
}
loadEnts(); refresh();
</script></body></html>"""


class Editor:
    """The live editor's state: the editor scene, its undo ring, the cached
    render scene, and play mode's clone (reference: editor_scene play /
    pause / stop with scene cloning, src/scene/scene.h:399-463 +
    editor.cpp).  `play` clones the editor scene and compiles its physics
    on the device; each render in play mode advances the CLONE one 1/60 s
    frame (`physics_step` at the default settings); `stop` discards the clone, leaving the editor scene as it
    was.  Joint parameters ride `physics_step`'s motor overrides, so a live
    motor edit takes effect on the next frame."""

    def __init__(self, scene: Scene, size: int = 256, spp: int = 6,
                 device="cuda", orbit_radius: Optional[float] = None):
        from ..cuda_build import resolve_device

        self.scene = scene
        self.size, self.spp = size, spp
        self.device = resolve_device(device)
        self.orbit_radius = orbit_radius
        self.undo = UndoStack()
        self.lock = threading.Lock()          # one render / edit at a time
        self._rscene = None
        self.play = {"mode": "edit", "scene": None, "arch": None,
                     "state": None, "mapping": None, "mo": None, "frames": 0}

    # -- render scenes --------------------------------------------------------

    def rscene(self):
        if self._rscene is None:
            self._rscene = self.scene.build_render_scene(device=self.device)
        return self._rscene

    def invalidate(self):
        self._rscene = None

    def play_rscene(self, advance: bool):
        p = self.play
        if advance:
            self.step_play()
        return p["scene"].build_render_scene(
            body_state=p["state"], mapping=p["mapping"], device=self.device)

    # -- play mode --------------------------------------------------------------

    @staticmethod
    def _motor_overrides(arch):
        return tuple({k: v[None] for k, v in t.params.items()}
                     for t in arch.joints)

    def start_play(self):
        if self.play["mode"] != "edit":      # pause -> resume
            self.play["mode"] = "play"
            return
        clone = self.scene.clone()
        arch, state, mapping = clone.compile_physics(device=self.device)
        self.play.update(scene=clone, arch=arch, state=state,
                         mapping=mapping, mo=self._motor_overrides(arch),
                         frames=0, mode="play")

    def step_play(self):
        """Advance the play clone one 1/60 s frame."""
        from ..physics.step import physics_step
        from ..physics.types import PhysicsSettings

        p = self.play
        with torch.inference_mode():
            p["state"] = physics_step(
                p["arch"], p["state"], PhysicsSettings(), PLAY_DT,
                motor_overrides=p["mo"] or None)[0]
        p["frames"] += 1

    def stop_play(self):
        self.play.update(mode="edit", scene=None, arch=None, state=None,
                         mapping=None, mo=None, frames=0)

    def _rebuild_play_arch(self):
        """Recompile the play clone's physics tables after a live edit,
        KEEPING the running body state (the edit changed parameter values,
        not the body/joint layout); the joints' parameters go in as the
        next frames' motor overrides."""
        arch2, _, mapping2 = self.play["scene"].compile_physics(
            device=self.device)
        self.play.update(arch=arch2, mapping=mapping2,
                         mo=self._motor_overrides(arch2))

    # -- requests -----------------------------------------------------------------

    def render_png(self, q: dict) -> bytes:
        theta = float(q.get("theta", ["0.8"])[0])
        phi = float(q.get("phi", ["0.45"])[0])
        size = int(q.get("size", [str(self.size)])[0])
        spp = int(q.get("spp", [str(self.spp)])[0])
        kind = q.get("kind", ["beauty"])[0]
        if kind not in ("beauty", "normals", "depth", "ao"):
            raise ValueError(f"unknown render kind {kind!r}")
        if self.play["mode"] in ("play", "pause"):
            rs = self.play_rscene(advance=self.play["mode"] == "play")
        else:
            rs = self.rscene()
        center, radius = scene_center_radius(rs, self.orbit_radius)
        if "radius" in q:
            radius = float(q["radius"][0])
        cam = orbit_camera(center, radius, theta, phi, device=self.device)
        if kind == "beauty":
            return png_bytes(beauty(rs, cam, size, spp))
        from ..render import post
        from ..render.gbuffer import render_gbuffer

        gb = render_gbuffer(rs, cam, size, size)
        if kind == "normals":
            return png_bytes(normals_u8(gb.normal.cpu().numpy()))
        if kind == "depth":
            return png_bytes(gray_u8(gb.depth.cpu().numpy()))
        return png_bytes(gray_u8(
            post.hbao(gb.view_pos, gb.view_normal).cpu().numpy()))

    def entities_json(self):
        out = []
        sc = self.scene
        for ent, _ in sc.view():
            comps = [k for k in sc._components if ent.has(k)]
            row = {"id": ent.id, "name": ent.name, "components": comps,
                   "detail": {}}
            tf = ent.get("transform")
            if tf is not None:
                row["position"] = [float(x) for x in tf.position]
                row["rotation"] = [float(x) for x in tf.rotation]
            # Full component reflection (the reference inspector edits every
            # component, editor.cpp drawComponent loops).
            for k in comps:
                v = sc._components[k][ent.id]
                if isinstance(v, list):
                    row["detail"][k] = [C.to_plain(c) for c in v]
                else:
                    row["detail"][k] = C.to_plain(v)
            out.append(row)
        return out

    def info(self):
        center, radius = scene_center_radius(self.rscene(), self.orbit_radius)
        return {"radius": radius, "center": [float(x) for x in center],
                "undo": self.undo.undo_name, "redo": self.undo.redo_name,
                "mode": self.play["mode"], "frames": self.play["frames"]}

    def physics_json(self):
        """Play-mode body state per entity (the live-edit observability
        hook: the editor reads back rigid-body state every frame)."""
        p = self.play
        if p["mode"] == "edit" or p["state"] is None:
            raise EditRefused("not playing")
        st = p["state"]
        pos, vel, omega = (x[0].cpu().numpy() for x in (st.pos, st.vel,
                                                        st.omega))
        rows = {str(eid): {"position": pos[b].tolist(),
                           "lin_vel": vel[b].tolist(),
                           "ang_vel": omega[b].tolist()}
                for eid, b in p["mapping"].items()}
        return {"frames": p["frames"], "bodies": rows}

    @staticmethod
    def _comp_slot(sc, eid, kind, index):
        """(store, current value) for a component slot on a scene."""
        store = sc._components.get(kind, {})
        if eid not in store:
            raise KeyError(f"entity {eid} has no {kind}")
        cur = store[eid]
        if isinstance(cur, list):
            if index is None or not (0 <= index < len(cur)):
                raise KeyError(f"{kind} index {index} out of range")
        return store, cur

    def _set_comp(self, sc, eid, kind, index, new):
        store, cur = self._comp_slot(sc, eid, kind, index)
        if isinstance(cur, list):
            old = cur[index]
            cur[index] = new
        else:
            old = cur
            store[eid] = new
        return old

    def _make_toggle(self, eid, kind, index):
        def toggle(saved):
            replaced = self._set_comp(self.scene, eid, kind, index, saved)
            if self.play["mode"] != "edit" and self.play["scene"] is not None:
                self._set_comp(self.play["scene"], eid, kind, index, saved)
                self._rebuild_play_arch()
            self.invalidate()
            return replaced
        return toggle

    def apply_edit(self, doc):
        """Edit any component's fields with undo.

        {"id": eid, "component": kind, "index": i?, "fields": {...}} — or
        the transform shorthand {"id", "position"/"rotation"/"scale"}.
        During play/pause, edits apply to BOTH the editor scene and the
        running clone; physics components rebuild the clone's tables in
        place (live motor retargeting)."""
        eid = int(doc["id"])
        kind = doc.get("component", "transform")
        index = doc.get("index")
        if "fields" in doc:
            fields = doc["fields"]
        else:
            fields = {k: doc[k] for k in ("position", "rotation", "scale")
                      if k in doc}
        _, cur = self._comp_slot(self.scene, eid, kind, index)
        old = cur[index] if isinstance(cur, list) else cur
        valid = {f.name for f in dataclasses.fields(old)}
        changes = {}
        for k, v in fields.items():
            if k not in valid:
                raise KeyError(f"{kind} has no field {k!r}")
            proto = getattr(old, k)
            if isinstance(v, list):
                v = tuple(float(x) for x in v)
            elif isinstance(proto, bool):
                v = bool(v)
            elif isinstance(proto, int):
                v = int(v)
            elif isinstance(proto, float):
                v = float(v)
            changes[k] = v
        new = dataclasses.replace(old, **changes)
        if kind == "transform" and self.play["mode"] != "edit":
            raise EditRefused("stop playback to move entities")
        name = self.scene._names.get(eid, f"entity{eid}")
        self.undo.push(f"edit {name}", old, self._make_toggle(eid, kind,
                                                              index))
        self._set_comp(self.scene, eid, kind, index, new)
        if self.play["mode"] != "edit" and self.play["scene"] is not None:
            self._set_comp(self.play["scene"], eid, kind, index, new)
            if kind in ("joint", "rigid_body", "collider"):
                self._rebuild_play_arch()
        self.invalidate()

    def pause(self):
        if self.play["mode"] == "play":
            self.play["mode"] = "pause"


def make_server(editor: Editor, port: int = 8710):
    """A `ThreadingHTTPServer` on 127.0.0.1:`port` (0: any free port)
    answering / (the page), /render (kinds beauty / normals / depth / ao),
    /entities, /info, /physics and POST /edit, /play, /pause, /stop, /undo,
    /redo.  A refused edit answers 409, any other failure 500 with the
    error."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    def locked(fn):
        with editor.lock:
            return fn()

    gets = {
        "/render": lambda q: (locked(lambda: editor.render_png(q)),
                              "image/png"),
        "/entities": lambda q: (json.dumps(locked(
            editor.entities_json)).encode(), "application/json"),
        "/info": lambda q: (json.dumps(locked(editor.info)).encode(),
                            "application/json"),
        "/physics": lambda q: (json.dumps(locked(
            editor.physics_json)).encode(), "application/json"),
        "/": lambda q: (VIEWER_HTML.replace("SPP0", str(editor.spp))
                        .encode(), "text/html"),
    }

    def mode():
        return {"mode": editor.play["mode"]}

    posts = {
        "/edit": lambda doc: (editor.apply_edit(doc), {"ok": True})[1],
        "/play": lambda doc: (editor.start_play(), mode())[1],
        "/pause": lambda doc: (editor.pause(), mode())[1],
        "/stop": lambda doc: (editor.stop_play(), mode())[1],
        "/undo": lambda doc: {"undone": editor.undo.undo()},
        "/redo": lambda doc: {"redone": editor.undo.redo()},
    }

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, body, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

        def _answer(self, fn):
            try:
                code, body, ctype = fn()
            except EditRefused as e:
                code, body, ctype = 409, json.dumps(
                    {"error": str(e)}).encode(), "application/json"
            except Exception as e:  # the server keeps serving
                log_error("%s %s: %s", self.command, self.path,
                          traceback.format_exc())
                code, body, ctype = 500, json.dumps(
                    {"error": f"{type(e).__name__}: {e}"}).encode(), \
                    "application/json"
            self._send(code, body, ctype)

        def do_GET(self):
            u = urlparse(self.path)
            if u.path not in gets:
                return self._send(404, b"{}")
            self._answer(lambda: (200,) + gets[u.path](parse_qs(u.query)))

        def do_POST(self):
            u = urlparse(self.path)
            if u.path not in posts:
                return self._send(404, b"{}")
            n = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(n) if n else b"{}"
            self._answer(lambda: (200, json.dumps(locked(
                lambda: posts[u.path](json.loads(raw)))).encode(),
                "application/json"))

    return ThreadingHTTPServer(("127.0.0.1", port), Handler)


def serve(scene: Scene, port: int = 8710, size: int = 256, spp: int = 6,
          device="cuda", orbit_radius: Optional[float] = None):
    """Run the live viewer until interrupted."""
    httpd = make_server(Editor(scene, size, spp, device, orbit_radius), port)
    print(f"serving on http://127.0.0.1:{httpd.server_address[1]}/ "
          f"(ctrl-c to stop)", flush=True)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()


class Client:
    """A small HTTP client of the live viewer that times every request
    (`ms[path]`, host clock).  An answer other than 200 raises
    `urllib.error.HTTPError`."""

    def __init__(self, base: str, timeout: float = 300.0):
        self.base = base
        self.timeout = timeout
        self.ms: dict = {}

    def _open(self, req, path):
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            body = r.read()
        self.ms.setdefault(path.split("?")[0], []).append(
            (time.perf_counter() - t0) * 1e3)
        return body

    def get(self, path: str) -> bytes:
        return self._open(self.base + path, path)

    def get_json(self, path: str):
        return json.loads(self.get(path))

    def post(self, path: str, doc=None):
        req = urllib.request.Request(
            self.base + path, method="POST",
            data=json.dumps(doc).encode() if doc else b"",
            headers={"Content-Type": "application/json"})
        return json.loads(self._open(req, path))


# ---------------------------------------------------------------------------
# Static HTML
# ---------------------------------------------------------------------------

def write_static(scene: Scene, out: str, title: str = "demo",
                 size: int = 256, views: int = 4, spp: int = 6,
                 device="cuda", orbit_radius: Optional[float] = None) -> dict:
    """Write the static page to `out`: `views` orbit views path-traced at
    `size` with `spp` samples and recursion depth 2 (each from a generator
    seeded with its index), the first view's render targets, the physics
    line and the entity table.  Returns the page's parts: "views" and "aux"
    (uint8 images), "aux_float" (the panels' float arrays), "camera" (the
    first view's), "center", "radius", "physics" (the line's counts) and
    "rows"."""
    from ..cuda_build import resolve_device

    if views < 1:
        raise ValueError("views must be >= 1")
    device = resolve_device(device)
    arch, state, mapping = scene.compile_physics(device=device)
    rscene = scene.build_render_scene(body_state=state, mapping=mapping,
                                      device=device)
    center, radius = scene_center_radius(rscene, orbit_radius)

    view_imgs, aux, aux_float, first_cam = [], {}, {}, None
    for i in range(views):
        ang = 2 * math.pi * i / views
        cam = orbit_camera(center, radius, ang, STATIC_PHI, device=device)
        view_imgs.append((f"orbit {i * 360 // views}&deg;",
                          beauty(rscene, cam, size, spp, seed=i)))
        if i == 0:
            # Aux buffers from the first view (the editor's texture panels).
            first_cam = cam
            aux_float = aux_buffers(rscene, cam, size)
            aux = {k: aux_u8(k, v) for k, v in aux_float.items()}

    # Entity tree.
    rows = []
    for ent, _ in scene.view():
        comps = [k for k in scene._components if ent.has(k)]
        detail = []
        for k in comps:
            v = ent.get(k)
            if k == "transform":
                detail.append(
                    f"transform: pos="
                    f"{tuple(round(float(x), 3) for x in v.position)}")
            elif k == "collider":
                for c in v:
                    detail.append(f"collider: {c.shape} size={tuple(c.size)}")
            else:
                detail.append(f"{k}: {html.escape(str(v)[:120])}")
        rows.append((ent.id, ent.name, comps, detail))

    total_pairs = sum(b.body_a.shape[0] for b in arch.contact_buckets)
    joints = [(t.kind, t.body_a.shape[0]) for t in arch.joints]
    physics = dict(bodies=arch.num_bodies, colliders=arch.num_colliders,
                   planes=arch.num_planes, terrains=arch.num_terrains,
                   plane_rows=arch.vs_plane_collider.shape[0],
                   pair_rows=total_pairs, joints=joints)

    parts = [f"""<!doctype html><html><head><meta charset="utf-8">
<title>{html.escape(title)}</title><style>
body {{ font: 13px/1.5 system-ui, sans-serif; margin: 24px; background: #16181d; color: #d7dae0; }}
h1, h2 {{ font-weight: 600; }} code {{ color: #9ecbff; }}
.imgs img {{ image-rendering: pixelated; margin: 4px; border: 1px solid #333; }}
.cap {{ color: #8a8f98; font-size: 11px; text-align: center; }}
table {{ border-collapse: collapse; }} td, th {{ padding: 2px 10px; border-bottom: 1px solid #2a2d34; text-align: left; vertical-align: top; }}
details {{ margin-left: 8px; }} .cell {{ display: inline-block; }}
</style></head><body>
<h1>Scene: <code>{html.escape(title)}</code></h1>
<h2>Views (path traced)</h2><div class="imgs">"""]
    for cap, img in view_imgs:
        parts.append(f'<span class="cell"><img width="{size}" '
                     f'src="data:image/png;base64,{png_b64(img)}"><div '
                     f'class="cap">{cap}</div></span>')
    parts.append('</div><h2>Render targets (first view)</h2>'
                 '<div class="imgs">')
    for cap, img in aux.items():
        parts.append(f'<span class="cell"><img width="{size}" '
                     f'src="data:image/png;base64,{png_b64(img)}"><div '
                     f'class="cap">{cap}</div></span>')
    parts.append(f"""</div>
<h2>Physics</h2>
<p>{physics["bodies"]} bodies &middot; {physics["colliders"]} colliders &middot;
{physics["planes"]} planes &middot; {physics["terrains"]} terrains &middot;
{physics["plane_rows"]} plane rows &middot; {total_pairs} pair rows
&middot; joints: {", ".join(f"{n} {k}" for k, n in joints) or "none"}</p>
<h2>Entities ({len(rows)})</h2><table>
<tr><th>id</th><th>name</th><th>components</th></tr>""")
    for eid, name, comps, detail in rows:
        d = "<br>".join(html.escape(x) if not x.startswith("transform")
                        else x for x in detail)
        parts.append(f"<tr><td>{eid}</td><td>{html.escape(name)}</td>"
                     f"<td><details><summary>{', '.join(comps)}</summary>"
                     f"{d}</details></td></tr>")
    parts.append("</table></body></html>")

    with open(out, "w") as f:
        f.write("".join(parts))
    return {"views": [img for _, img in view_imgs], "aux": aux,
            "aux_float": aux_float, "camera": first_cam, "center": center,
            "radius": radius, "physics": physics, "rows": rows}


# ---------------------------------------------------------------------------
# A scripted editor session
# ---------------------------------------------------------------------------

def editor_session(client: Client, editor: Editor, size: int, spp: int,
                   play_frames: int = 120) -> dict:
    """Drive the live viewer of the demo scene (`build_demo_scene`) through
    every endpoint, as tests/test_scene_viewer.py's session does, and
    return what it observed: two orbits' PNGs, the aux kinds, a transform
    edit with undo and redo as /entities shows it, play for `play_frames`
    frames (a beauty render at PLAY_SPP samples each) with the bodies and
    the play clone's tables read before /stop, pause, the refused edit
    during play, the editor scene's document before play and after stop,
    a material edit with undo, and a live motor retarget of the paddle's
    hinge during a second play."""
    q = f"size={size}&spp={spp}"
    out = {"page": b"scene viewer" in client.get("/")}
    png = client.get(f"/render?{q}&theta=0.3&phi=0.5")
    png2 = client.get(f"/render?{q}&theta=2.1&phi=0.5")
    out["orbit_pngs"] = (png, png2)
    out["kinds"] = {k: client.get(f"/render?size={size}&kind={k}")
                    for k in ("normals", "depth", "ao")}

    def entity(name):
        return next(e for e in client.get_json("/entities")
                    if e["name"] == name)

    red = entity("RedSphere")
    xs = [red["position"][0]]
    client.post("/edit", {"id": red["id"], "position": [3.0, 0.8, 0.0]})
    xs.append(entity("RedSphere")["position"][0])
    out["edited_render"] = client.get(f"/render?{q}")
    names = [client.post("/undo")["undone"]]
    xs.append(entity("RedSphere")["position"][0])
    names.append(client.post("/redo")["redone"])
    xs.append(entity("RedSphere")["position"][0])
    out["info_after_redo"] = client.get_json("/info")
    names.append(client.post("/undo")["undone"])
    out["edit_x"], out["undo_redo_names"] = xs, names

    # Play mode: a clone stepped once per render; the editor scene keeps
    # its authored transforms.
    out["doc_before_play"] = editor.scene.to_document()
    out["play_mode"] = client.post("/play")["mode"]
    pq = f"size={size}&spp={PLAY_SPP}"
    first = client.get(f"/render?{pq}")
    for _ in range(play_frames - 2):
        client.get(f"/render?{pq}")
    later = client.get(f"/render?{pq}")
    out["play_pngs_differ"] = later != first
    out["physics"] = client.get_json("/physics")
    play = editor.play
    out["play_tables"] = (play["arch"], play["state"], play["mo"],
                          play["mapping"])
    frames = client.get_json("/info")["frames"]
    out["pause_mode"] = client.post("/pause")["mode"]
    client.get(f"/render?{pq}")
    out["frames"] = (frames, client.get_json("/info")["frames"])
    try:
        client.post("/edit", {"id": red["id"], "position": [0, 9, 0]})
        out["edit_during_play"] = 200
    except urllib.error.HTTPError as e:
        out["edit_during_play"] = e.code
    out["stop_mode"] = client.post("/stop")["mode"]
    out["doc_after_stop"] = editor.scene.to_document()
    out["red_after_stop"] = entity("RedSphere")["position"]

    # Material edit with undo.
    red = entity("RedSphere")
    albedo = [red["detail"]["material"]["albedo"][0]]
    client.post("/edit", {"id": red["id"], "component": "material",
                          "index": None, "fields": {
                              "albedo": [0.1, 0.9, 0.1], "roughness": 0.9}})
    albedo.append(entity("RedSphere")["detail"]["material"]["albedo"][1])
    names = [client.post("/undo")["undone"]]
    albedo.append(entity("RedSphere")["detail"]["material"]["albedo"][0])
    out["material_albedo"] = albedo

    # A live motor retarget during play.
    paddle = entity("Paddle")
    targets = [paddle["detail"]["joint"][0]["motor_target"]]
    client.post("/play")
    for _ in range(3):
        client.get(f"/render?{pq}")
    spins = [client.get_json("/physics")["bodies"][str(paddle["id"])][
        "ang_vel"][1]]
    client.post("/edit", {"id": paddle["id"], "component": "joint",
                          "index": 0, "fields": {"motor_target": 6.0}})
    for _ in range(8):
        client.get(f"/render?{pq}")
    spins.append(client.get_json("/physics")["bodies"][str(paddle["id"])][
        "ang_vel"][1])
    client.post("/stop")
    targets.append(entity("Paddle")["detail"]["joint"][0]["motor_target"])
    names.append(client.post("/undo")["undone"])
    targets.append(entity("Paddle")["detail"]["joint"][0]["motor_target"])
    out.update(paddle_spin=spins, motor_targets=targets,
               undo_names_after=names, doc_final=editor.scene.to_document())
    return out
