"""The bytes the SSR march kernel (`csrc/ssr.cu`) must move for one launch
over a game frame, counted from the configuration: every pixel of the
march's image (half the frame's width and height where the effects run at
half resolution) reads its ray's seven floats (x0, y0, dx, dy, k0, dk,
t_max: 28 bytes) and writes its hit parameter and flag (8 bytes), and the
linear-depth min-pyramid (every level, 4 bytes a texel) is read once.  The
march's steps are not counted: they depend on the scene, and a march that
takes fewer does not lower its own yardstick."""

RAY_BYTES = 28
OUT_BYTES = 8
TEXEL_BYTES = 4
MAX_MIP = 6               # render/post.py SSRSettings.max_mip


def levels(h: int, w: int, max_mip: int = MAX_MIP):
    """The texels of the min-pyramid of an (h, w) image: odd sides padded
    to even before each halving, at most max_mip + 1 levels."""
    total, hh, ww = h * w, h, w
    for _ in range(max_mip):
        if hh < 2 or ww < 2:
            break
        hh, ww = (hh + hh % 2) // 2, (ww + ww % 2) // 2
        total += hh * ww
    return total


def work(config: dict):
    """(operations, bytes) of one launch."""
    div = 2 if config["raster"]["half_res_effects"] else 1
    h, w = config["height"] // div, config["width"] // div
    return 0.0, (h * w * (RAY_BYTES + OUT_BYTES)
                 + levels(h, w) * TEXEL_BYTES)
