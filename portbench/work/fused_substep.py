"""The work of one launch of the fused env-step kernel (one control step of
every env), counted from the configuration and the reference's contacts:
the least any implementation must read, write and compute.

Bytes: each env's body state (position, rotation, velocity, angular
velocity, force, torque: 19 floats a body) read and written, its smoothed
action read, its obs, reward and done written.  Operations: the
`solver_iterations`-long sequential-impulse solve, every joint row of its
kind and every active plane-contact point once an iteration, at the per-row
counts below (a multiply and an add count 2, a clamp 1); the narrowphase,
the prep and the reward left out, so the count is a lower bound."""

ROW_FLOP = {"ball": 114, "distance": 62, "fixed": 174, "hinge": 250,
            "cone_twist": 255, "slider": 275}
CONTACT_POINT_FLOP = 85
BODY_FLOATS = 19


def work(config: dict, contact_points: float):
    """(operations, bytes) of one launch over `config["envs"]` envs with
    `contact_points` active plane-contact points summed over the envs."""
    envs = config["envs"]
    rows = sum(ROW_FLOP[kind] * n for kind, n in config["joints"].items())
    flop = config["solver_iterations"] * (envs * rows
                                          + contact_points * CONTACT_POINT_FLOP)
    bytes_moved = 4 * envs * (2 * BODY_FLOATS * config["bodies"]
                              + config["action"] + config["obs"] + 2)
    return flop, bytes_moved
