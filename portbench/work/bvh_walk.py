"""The bytes the BVH walk (kernel #3) must move for the rays of a set of
path-traced frames, counted from the rays and the scene, not from the walk:
each ray traced reads its origin, direction and t_max (28 bytes) and writes
t, triangle, u and v (16 bytes); each bounce level reads the scene's
triangles once (three float32 vertices, 36 bytes each), the sun's shadow
rays counted with their bounce.  The walk's box and plane tests are not
counted, so a smarter walk does not lower its own yardstick."""

RAY_IN_BYTES = 28
RAY_OUT_BYTES = 16
TRIANGLE_BYTES = 36


def work(config: dict, rays: int, frames: int):
    """(operations, bytes) of `frames` frames that traced `rays` rays."""
    levels = config["path_tracer"]["depth"] + 1
    triangles = config["scene"]["triangles"]
    return 0.0, (rays * (RAY_IN_BYTES + RAY_OUT_BYTES)
                 + frames * levels * triangles * TRIANGLE_BYTES)
