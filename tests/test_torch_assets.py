"""The port's assets (`assets/image_io.py`, `texcompress.py`, `cache.py`,
`envmap.py`) and image-based lighting (`render/ibl.py`,
`render/resources.py`) against the JAX package on the CPU: codecs
bit-equal (bytes written and arrays decoded), a cache file written by
either package read by the other bit-equal, the cubemap's nearest texels
equal away from texel edges, the SH, prefilter and BRDF LUT within
float32 rounding."""

import math
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3d12renderer_tpu.assets import cache as jcache
from d3d12renderer_tpu.assets import envmap as jenv
from d3d12renderer_tpu.assets import image_io as jio
from d3d12renderer_tpu.assets import texcompress as jtex
from d3d12renderer_tpu.render import ibl as jibl
from d3d12renderer_tpu.render import resources as jres
from d3d12renderer_tpu_torch.assets import cache as tcache
from d3d12renderer_tpu_torch.assets import envmap as tenv
from d3d12renderer_tpu_torch.assets import image_io as tio
from d3d12renderer_tpu_torch.assets import texcompress as ttex
from d3d12renderer_tpu_torch.render import ibl as tibl
from d3d12renderer_tpu_torch.render import resources as tres

STUDIO = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples", "data", "studio.hdr")
# The equirect lookup truncates to a texel: a direction within EDGE_EPS
# (in texels) of a texel edge may take either texel after one ulp of acos
# or atan2, so indices are compared away from edges and the rest counted.
EDGE_EPS = 1e-5
EDGE_SHARE = 0.01
# SH, prefilter and the BRDF LUT sum thousands of float32 terms in
# another order.
SUM_TOL = 1e-4


def _hdr_image(h, w, seed):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 4, (h, w, 3)).astype(np.float32) ** 3
    img[: h // 2, : w // 3] = 0.7            # runs for the RLE
    img[-1, -1] = 0.0
    return img


@pytest.mark.parametrize("w", [5, 64, 300])
def test_hdr_codec_matches_jax(tmp_path, w):
    """`save_hdr` writes the same bytes (RLE scanlines for widths 8-32767,
    flat ones otherwise) and `load_hdr` decodes them bit-equal, in both
    directions; the committed studio.hdr decodes bit-equal."""
    img = _hdr_image(17, w, w)
    jio.save_hdr(str(tmp_path / "j.hdr"), img)
    tio.save_hdr(str(tmp_path / "t.hdr"), img)
    assert (tmp_path / "j.hdr").read_bytes() == (tmp_path / "t.hdr").read_bytes()
    for name in ("j.hdr", "t.hdr"):
        np.testing.assert_array_equal(tio.load_hdr(str(tmp_path / name)),
                                      jio.load_hdr(str(tmp_path / name)))
    got = tio.load_hdr(STUDIO)
    np.testing.assert_array_equal(got, jio.load_hdr(STUDIO))
    assert got.shape == (128, 256, 3) and got.dtype == np.float32


@pytest.mark.parametrize("half", [False, True])
def test_exr_codec_matches_jax(tmp_path, half):
    img = _hdr_image(9, 13, 3)
    jio.save_exr(str(tmp_path / "j.exr"), img, half=half)
    tio.save_exr(str(tmp_path / "t.exr"), img, half=half)
    assert (tmp_path / "j.exr").read_bytes() == (tmp_path / "t.exr").read_bytes()
    got = tio.load_exr(str(tmp_path / "t.exr"))
    np.testing.assert_array_equal(got, jio.load_exr(str(tmp_path / "t.exr")))
    want = img.astype(np.float16).astype(np.float32) if half else img
    np.testing.assert_array_equal(got, want)


def test_png16_matches_jax(tmp_path):
    pytest.importorskip("PIL")
    a = np.random.default_rng(4).uniform(0, 1, (11, 7)).astype(np.float32)
    jio.save_png16(str(tmp_path / "j.png"), a)
    tio.save_png16(str(tmp_path / "t.png"), a)
    got = tio.load_png16(str(tmp_path / "t.png"))
    np.testing.assert_array_equal(got, jio.load_png16(str(tmp_path / "j.png")))
    np.testing.assert_allclose(got[..., 0], a, rtol=0, atol=1.0 / 65535)


@pytest.mark.parametrize("hdr", [False, True])
def test_texcompress_matches_jax(hdr):
    """`pack_mips` / `unpack_mips`: BC1 blocks for 8-bit LDR (ragged sizes
    padded to 4x4 blocks), float16 for HDR; payloads and decodes
    bit-equal."""
    rng = np.random.default_rng(7)
    if hdr:
        mips = [_hdr_image(10, 18, 1), _hdr_image(5, 9, 2)]
    else:
        srgb = rng.integers(0, 256, (13, 22, 3)) / 255.0
        lin = np.where(srgb <= 0.04045, srgb / 12.92,
                       ((srgb + 0.055) / 1.055) ** 2.4).astype(np.float32)
        mips = [lin, lin[::2, ::2].copy(), lin[:3, :3].copy()]
    jp = jtex.pack_mips(mips, hdr=hdr)
    tp = ttex.pack_mips(mips, hdr=hdr)
    for a, b in zip(jp["mips"], tp["mips"]):
        assert a["format"] == b["format"]
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    formats = [m["format"] for m in tp["mips"]]
    assert formats == (["f16"] * 2 if hdr else ["bc1", "bc1", "f16"])
    for a, b in zip(jtex.unpack_mips(jp), ttex.unpack_mips(tp)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("mips", [False, True])
def test_cache_file_read_across_packages(tmp_path, writer, mips):
    """A cache file written by one package is a hit for the other: the
    same `<src>.cache_<sha1>.bin` name and pickle format, the mips
    bit-equal to the writer's."""
    src = str(tmp_path / "studio.hdr")
    shutil.copy(STUDIO, src)
    first, second = (jcache, tcache) if writer == "jax" else (tcache, jcache)
    a, hit_a = first.load_image_cached(src, generate_mips=mips)
    assert not hit_a
    names = [n for n in os.listdir(tmp_path) if ".cache_" in n]
    assert len(names) == 1
    b, hit_b = second.load_image_cached(src, generate_mips=mips)
    assert hit_b
    assert len(a) == len(b) == (8 if mips else 1)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert tcache._cache_path(src, f"mips={mips}") == \
        jcache._cache_path(src, f"mips={mips}")


def test_load_image_and_loader_cache_match_jax(tmp_path):
    """`load_image` with mips bit-equal; `load_with_cache` without
    pack / unpack (a miss, then a hit; a newer source invalidates)."""
    for x, y in zip(tio_mips := tcache.load_image(STUDIO, True),
                    jcache.load_image(STUDIO, True)):
        np.testing.assert_array_equal(x, y)
    assert tio_mips[-1].shape[:2] == (1, 2)
    src = tmp_path / "a.txt"
    src.write_text("hello")
    calls = []

    def loader(p):
        calls.append(p)
        return open(p).read()

    assert tcache.load_with_cache(str(src), loader, "k") == ("hello", False)
    assert jcache.load_with_cache(str(src), loader, "k") == ("hello", True)
    os.utime(src, (1, 1))
    assert tcache.load_with_cache(str(src), loader, "k") == ("hello", False)
    assert len(calls) == 2


def test_file_registry_matches_jax(tmp_path):
    """Handles from the same seed equal; the YAML either writes is read by
    the other; added, modified and deleted files reported alike."""
    pytest.importorskip("yaml")
    for name in ("a.png", "b.hdr", "c/d.exr"):
        p = tmp_path / name
        p.parent.mkdir(exist_ok=True)
        p.write_bytes(b"x")
    jr = jcache.FileRegistry(str(tmp_path), seed=5)
    tr = tcache.FileRegistry(str(tmp_path), registry_file="t.yaml", seed=5)
    assert jr.handle_to_path == tr.handle_to_path
    tr.save()
    back = jcache.FileRegistry(str(tmp_path), registry_file="t.yaml")
    assert back.handle_to_path == tr.handle_to_path
    events = []
    tr.on_change(lambda kind, rel: events.append((kind, rel)))
    (tmp_path / "e.hdr").write_bytes(b"y")
    os.remove(tmp_path / "a.png")
    os.utime(tmp_path / "b.hdr", (1, 1))
    tr.scan()
    assert sorted(events) == [("added", "e.hdr"), ("deleted", "a.png"),
                              ("modified", "b.hdr")]
    assert tr.path_for(tr.handle_for(str(tmp_path / "b.hdr"))) == str(
        tmp_path / "b.hdr")
    # The polling watcher reports a new file, then stops.
    import time

    tr.start_watcher(interval=0.05)
    (tmp_path / "f.exr").write_bytes(b"z")
    for _ in range(100):
        if ("added", "f.exr") in events:
            break
        time.sleep(0.05)
    tr.stop_watcher()
    assert ("added", "f.exr") in events and tr._watcher is None


def test_envmap_matches_jax(tmp_path):
    np.testing.assert_array_equal(tenv.make_demo_envmap(32),
                                  jenv.make_demo_envmap(32))
    assert tenv.DEFAULT_SUN == jenv.DEFAULT_SUN
    p = tenv.ensure_demo_envmap(str(tmp_path / "sub" / "env.hdr"), 16)
    jenv.ensure_demo_envmap(str(tmp_path / "j.hdr"), 16)
    assert open(p, "rb").read() == (tmp_path / "j.hdr").read_bytes()
    # The committed asset is this map at 128 rows: its peak is the
    # circumsolar glow (8.3), the 0.53-degree disc falling between texel
    # centres 1.4 degrees apart.
    np.testing.assert_allclose(tio.load_hdr(STUDIO).max(),
                               tenv.make_demo_envmap(128).max(), rtol=1e-2)


def _texel_frac(shape, d):
    """The equirect texel coordinates of directions d, in float64."""
    he, we = shape[0], shape[1]
    d = d.astype(np.float64)
    theta = np.arccos(np.clip(d[..., 1], -1, 1))
    phi = np.arctan2(d[..., 2], d[..., 0])
    return theta / math.pi * (he - 1), (phi / (2 * math.pi) + 0.5) * (we - 1)


@pytest.mark.parametrize("face", [16, 128])
def test_equirect_to_cubemap_texels_match_jax(face):
    """The cube directions within 1e-7; each cube texel's equirect texel
    equal to JAX's wherever its direction lies more than EDGE_EPS texels
    from a texel edge (at most EDGE_SHARE of texels lie that close), and
    the cubemap's values equal there."""
    env = jio.load_hdr(STUDIO)
    want = np.asarray(jibl.equirect_to_cubemap(jnp.asarray(env), face))
    got = tibl.equirect_to_cubemap(torch.as_tensor(env), face).numpy()
    dirs = tibl.cube_directions(face).numpy()
    u = (np.arange(face) + 0.5) / face * 2 - 1
    gu, gv = np.meshgrid(u, u)
    one = np.ones_like(gu)
    jd = np.stack([np.stack(f, -1) for f in (
        (one, -gv, -gu), (-one, -gv, gu), (gu, one, gv), (gu, -one, -gv),
        (gu, -gv, one), (-gu, -gv, -one))])
    jd = jd / np.linalg.norm(jd, axis=-1, keepdims=True)
    np.testing.assert_allclose(dirs, jd, rtol=0, atol=1e-7)
    v, uu = _texel_frac(env.shape, dirs)
    far = ((np.abs(v - np.round(v)) > EDGE_EPS)
           & (np.abs(uu - np.round(uu)) > EDGE_EPS))
    assert far.mean() >= 1 - EDGE_SHARE, far.mean()
    np.testing.assert_array_equal(got[far], want[far])
    iv, iu = tibl.equirect_texel(env.shape, torch.as_tensor(dirs))
    np.testing.assert_array_equal(env[iv.numpy(), iu.numpy()], got)
    assert got.shape == (6, face, face, 3) and got.max() > 8.0


def test_sh9_prefilter_and_brdf_lut_match_jax():
    """SH projection and evaluation of an analytic sky, the GGX prefilter
    with JAX's sample draws injected, and the BRDF LUT (its radical
    inverse exact), each within SUM_TOL."""
    def env_np(d, xp):
        return xp.stack([0.5 + 0.5 * d[:, 1], 0.3 + 0.2 * d[:, 0] ** 2,
                         (d[:, 2] + abs(d[:, 2])) * 1.0], -1)

    jsh = np.asarray(jibl.irradiance_sh9(lambda d: env_np(d, jnp), 1024))
    tsh = tibl.irradiance_sh9(lambda d: env_np(d, torch), 1024)
    np.testing.assert_allclose(tsh.numpy(), jsh, rtol=0, atol=SUM_TOL)
    n = np.random.default_rng(3).normal(size=(64, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    np.testing.assert_allclose(
        tibl.eval_irradiance_sh9(tsh, torch.as_tensor(n)).numpy(),
        np.asarray(jibl.eval_irradiance_sh9(jnp.asarray(jsh),
                                            jnp.asarray(n))),
        rtol=0, atol=SUM_TOL)

    levels, nd, ns = (0.0, 0.5, 1.0), 32, 16
    key = jax.random.PRNGKey(4)
    draws = [(np.asarray(jax.random.uniform(jax.random.fold_in(
        key, int(r * 100)), (ns,))), np.asarray(jax.random.uniform(
            jax.random.fold_in(key, int(r * 100) + 1), (ns,))))
        for r in levels]
    jd, jl = jibl.prefilter_ggx(lambda d: env_np(d, jnp), levels, nd, ns, key)
    td, tl = tibl.prefilter_ggx(lambda d: env_np(d, torch), levels, nd, ns,
                                draws=draws)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=SUM_TOL)

    want = np.asarray(jibl.brdf_lut(16, 64))
    got = tibl.brdf_lut(16, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SUM_TOL)
    assert got.shape == (16, 16, 2) and 0.0 < float(got.max()) <= 1.0 + 1e-3


def test_resources_match_jax():
    tres.clear_cache()
    for name in ("default_white", "default_black", "default_normal_map"):
        np.testing.assert_array_equal(
            getattr(tres, name)(8, device="cpu").numpy(),
            np.asarray(getattr(jres, name)(8)))
    np.testing.assert_array_equal(tres.checker_texture(16, 4, "cpu").numpy(),
                                  np.asarray(jres.checker_texture(16, 4)))
    lut = tres.brdf_lookup(8, device="cpu")
    assert tres.brdf_lookup(8, device="cpu") is lut
    np.testing.assert_allclose(lut.numpy(), np.asarray(jres.brdf_lookup(8)),
                               rtol=0, atol=SUM_TOL)
