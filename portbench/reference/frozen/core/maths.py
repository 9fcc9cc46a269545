"""Vector / quaternion math on torch tensors (counterpart of
the JAX package's ``core/maths.py``).

Every function works on a trailing component axis and broadcasts over any
leading axes, so ``quat_mul`` takes ``(4,)``, ``(N, 4)`` or ``(B, N, 4)``.
Quaternions are ``(x, y, z, w)``.  The formulas and their operation order
follow the JAX module so that both round alike on the CPU.
"""

from __future__ import annotations

import functools

import torch

GRAVITY = -9.81


@functools.lru_cache(maxsize=None)
def constant(values: tuple, dtype: torch.dtype, device: torch.device):
    """A small constant tensor, built once per (values, dtype, device): a
    tensor built from host data on the card waits for the card's queue.
    Callers must not write to it."""
    return torch.tensor(values, dtype=dtype, device=device)


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def squared_length(a):
    return torch.sum(a * a, dim=-1)


def length(a):
    return torch.sqrt(squared_length(a))


def normalize(a, eps=1e-12):
    return a / torch.clamp(length(a), min=eps)[..., None]


def roll2(x, dy, dx):
    """Roll an image by dy rows and dx columns (wrapping)."""
    return torch.roll(x, (dy, dx), (0, 1))


def noz(a, eps_sq=1e-8):
    """Normalize-or-zero."""
    sl = squared_length(a)
    n = a / torch.sqrt(torch.clamp(sl, min=eps_sq))[..., None]
    return torch.where((sl < eps_sq)[..., None], torch.zeros_like(n), n)


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def quat_mul(a, b):
    """Hamilton product a*b."""
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        dim=-1,
    )


def quat_conj(q):
    return q * constant((-1.0, -1.0, -1.0, 1.0), q.dtype, q.device)


def quat_rotate(q, v):
    """v + 2 * cross(q.xyz, cross(q.xyz, v) + q.w * v)."""
    u = q[..., :3]
    w = q[..., 3:4]
    t = cross(u, v) + w * v
    return v + 2.0 * cross(u, t)


def quat_inv_rotate(q, v):
    return quat_rotate(quat_conj(q), v)


def quat_from_axis_angle(axis, angle):
    half = 0.5 * angle
    return torch.cat(
        [axis * torch.sin(half)[..., None], torch.cos(half)[..., None]], dim=-1)


def quat_to_mat3(q):
    """Unit quaternion -> (..., 3, 3) rotation matrix."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def quat_integrate(q, omega, dt):
    """normalize(q + dt * (0.5 * omega, 0) * q): semi-implicit Euler."""
    omega_q = torch.cat([0.5 * omega, torch.zeros_like(omega[..., :1])], dim=-1)
    dq = quat_mul(omega_q, q)
    return normalize(q + dq * dt)


def orthonormal_basis(n):
    """Two unit tangents orthogonal to unit n (Duff et al., branch-free)."""
    sign = torch.where(n[..., 2] >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t1 = torch.stack(
        [1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b, -sign * n[..., 0]],
        dim=-1)
    t2 = torch.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], dim=-1)
    return t1, t2


def quat_from_to(a, b):
    """Shortest-arc rotation taking unit vector a to unit vector b."""
    a, b = torch.broadcast_tensors(a, b)
    w = 1.0 + dot(a, b)
    v = cross(a, b)
    t1, _ = orthonormal_basis(a)
    anti = w < 1e-6
    v = torch.where(anti[..., None], t1, v)
    w = torch.where(anti, torch.zeros_like(w), w)
    return normalize(torch.cat([v, w[..., None]], dim=-1))


def quat_to_axis_angle(q):
    """(axis, signed angle = 2 * atan2(|v|, w))."""
    v = q[..., :3]
    l = length(v)
    angle = 2.0 * torch.atan2(l, q[..., 3])
    fallback = torch.zeros_like(v)
    fallback[..., 0] = 1.0
    axis = torch.where((l > 1e-9)[..., None],
                       v / torch.clamp(l, min=1e-9)[..., None], fallback)
    return axis, angle


def mat3_vec(mat, v):
    """(..., 3, 3) @ (..., 3) -> (..., 3), as a broadcast sum."""
    return torch.sum(mat * v[..., None, :], dim=-1)

