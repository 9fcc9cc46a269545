"""The JAX package's random draws for the world's modules, rebuilt from
their keys as the JAX functions split them, as numpy arrays for the port's
`draws` arguments (terrain.placement, terrain.grass, particles.systems,
models.world)."""

import jax
import numpy as np


def _u(key, shape):
    return np.asarray(jax.random.uniform(key, shape))


def _n(key, shape):
    return np.asarray(jax.random.normal(key, shape))


def placement_points(key, n):
    """`generate_placement_points(key)` for n points."""
    kj, kr, ks, kd = jax.random.split(key, 4)
    return {"jitter": _u(kj, (n, 2)), "rotation": _u(kr, (n,)),
            "scale": _u(ks, (n,)), "density": _u(kd, (n,))}


def placement_layers(key, n, layers):
    """`generate_placement_layers(key)` for n points and `layers` layers."""
    base, choice = jax.random.split(key)
    out = []
    for i in range(layers):
        kd, kc, choice = jax.random.split(jax.random.fold_in(choice, i), 3)
        out.append({"density": _u(kd, (n,)), "choice": _u(kc, (n,))})
    return {"points": placement_points(base, n), "layers": out}


def grass(key, n):
    """`generate_grass_blades(key)` for n blades."""
    return {"points": placement_points(key, n),
            "height": _u(jax.random.fold_in(key, 17), (n,))}


def emissions(system, key, steps, k=64):
    """The emission draws of `steps` `step_pool` calls of a pool whose key
    is `key`, for `system` in fire / smoke / debris / boids."""
    out = []
    for _ in range(steps):
        key, ke = jax.random.split(key)
        if system == "fire":
            k1, k2, k3 = jax.random.split(ke, 3)
            out.append({"radius": _u(k1, (k,)), "angle": _u(k2, (k,)),
                        "speed": _u(k3, (k,)), "life": _u(ke, (k,))})
        elif system == "smoke":
            k1, k2 = jax.random.split(ke)
            out.append({"position": _n(k1, (k, 3)),
                        "velocity": _n(k2, (k, 3)), "life": _u(ke, (k,))})
        elif system == "debris":
            k1, k2 = jax.random.split(ke)
            out.append({"direction": _n(k1, (k, 3)), "speed": _u(k2, (k,))})
        else:
            k1, k2 = jax.random.split(ke)
            out.append({"position": _n(k1, (k, 3)),
                        "velocity": _n(k2, (k, 3))})
    return out
