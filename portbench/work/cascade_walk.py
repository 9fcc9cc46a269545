"""The bytes kernel #3 must move for one launch over a game frame's sun
cascades, counted from the configuration, not from the walk: each of the
cascades' rays (cascades x resolution^2) reads its origin, direction and
t_max (28 bytes) and writes its t and row (8 bytes); the frame's posed
rows are read once (three float32 vertices, 36 bytes each).  The walk's
box and plane tests are not counted, so a smarter walk does not lower its
own yardstick."""

RAY_IN_BYTES = 28
RAY_OUT_BYTES = 8
TRIANGLE_BYTES = 36


def work(config: dict):
    """(operations, bytes) of one launch over the frame's cascades."""
    r = config["raster"]
    rays = r["sun_cascades"] * r["cascade_resolution"] ** 2
    return 0.0, (rays * (RAY_IN_BYTES + RAY_OUT_BYTES)
                 + config["pile"]["rows"] * TRIANGLE_BYTES)
