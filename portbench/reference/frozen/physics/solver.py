"""Sequential-impulse contact solve (counterpart of
the JAX package's ``physics/solver.py``).

Per contact point, one friction impulse along a fixed tangent, then the
normal impulse with accumulated clamping and a restitution + Baumgarte bias.
Three modes:

* colored: rows of one static color share no dynamic body, so a color is
  one batched gather / solve / scatter; colors run in order (Gauss-Seidel).
* split_jacobi: every row at once against bodies split into `deg` pieces
  (effective masses deg times lighter), the velocity deltas summed back
  with `index_add_`.  The JAX package swaps its gather / scatter for
  one-hot matmuls on large tables because XLA's TPU scatter-add
  serialises; the port has one Jacobi solve for both of its branches.
* runtime_gs: Gauss-Seidel over colors claimed each substep
  (`runtime_color`) for pair sets that change every step.

Tensors carry a leading scene axis B.  Contact tables name their bodies
with (P,) indices shared by every scene (static rows) or (B, P) indices
(the runtime broadphase's); `gather_rows` / `scatter_add_rows` take both.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

from ..core import maths as m
from .narrow import ContactTable

CONTACT_SLOP = 0.001
BAUMGARTE_SCALE = 0.1
DT_THRESHOLD = 1e-5


@dataclass
class ContactPrep:
    """Per-(row, point) constraint data, fixed during the iterations."""

    r_a: torch.Tensor        # (B, P, 4, 3) anchor relative to body A's COG
    r_b: torch.Tensor        # (B, P, 4, 3)
    normal: torch.Tensor     # (B, P, 3)
    tangent: torch.Tensor    # (B, P, 4, 3)
    bias: torch.Tensor       # (B, P, 4)
    eff_mass_n: torch.Tensor # (B, P, 4)
    eff_mass_t: torch.Tensor # (B, P, 4)
    n_to_wa: torch.Tensor    # (B, P, 4, 3) impulse -> delta omega maps
    n_to_wb: torch.Tensor    # (B, P, 4, 3)
    t_to_wa: torch.Tensor    # (B, P, 4, 3)
    t_to_wb: torch.Tensor    # (B, P, 4, 3)
    inv_mass_a: torch.Tensor # (B, P)
    inv_mass_b: torch.Tensor # (B, P)
    friction: torch.Tensor   # (B, P)
    pmask: torch.Tensor      # (B, P, 4) bool
    body_a: torch.Tensor     # (P,) or (B, P) int64
    body_b: torch.Tensor     # (P,) or (B, P) int64


@dataclass
class ColorPlan:
    """Static gather / scatter indices of one color of one table.  Only
    dynamic bodies are written back: static and kinematic bodies never take
    an impulse, and every plane row names the world slot, so writing them
    would be a duplicate-index scatter."""

    rows: torch.Tensor     # (R,) row indices into the table
    ia: torch.Tensor       # (R,) body ids
    ib: torch.Tensor
    a_pos: torch.Tensor    # rows whose body A is dynamic ...
    a_ids: torch.Tensor    # ... and those bodies
    b_pos: torch.Tensor
    b_ids: torch.Tensor


def color_plans(color_indices: Sequence[torch.Tensor], body_a, body_b,
                dynamic: np.ndarray) -> List[ColorPlan]:
    device = body_a.device
    ba, bb = body_a.cpu().numpy(), body_b.cpu().numpy()
    plans = []
    for idx in color_indices:
        rows = idx.cpu().numpy()
        ia, ib = ba[rows], bb[rows]
        a_pos = np.nonzero(dynamic[ia])[0]
        b_pos = np.nonzero(dynamic[ib])[0]

        def t(x):
            return torch.as_tensor(np.asarray(x, np.int64), device=device)

        plans.append(ColorPlan(rows=t(rows), ia=t(ia), ib=t(ib),
                               a_pos=t(a_pos), a_ids=t(ia[a_pos]),
                               b_pos=t(b_pos), b_ids=t(ib[b_pos])))
    return plans


def scatter_bodies(plan: ColorPlan, vel, omega, va, wa, vb, wb):
    """Write the solved velocities of the color's dynamic bodies in place."""
    vel[:, plan.a_ids] = va[:, plan.a_pos]
    omega[:, plan.a_ids] = wa[:, plan.a_pos]
    vel[:, plan.b_ids] = vb[:, plan.b_pos]
    omega[:, plan.b_ids] = wb[:, plan.b_pos]


def gather_rows(x, idx):
    """Rows of x (B, S, ...) at body indices idx (P,) or (B, P) ->
    (B, P, ...)."""
    if idx.dim() == 1:
        return x[:, idx]
    return torch.gather(x, 1, idx.reshape(idx.shape + (1,) * (x.dim() - 2))
                        .expand(idx.shape + x.shape[2:]))


def prep_contacts_full(ct: ContactTable, body_pos, inv_mass, inv_inertia_w,
                       vel, omega, dt, inv_mass_eff=None,
                       inv_inertia_eff=None) -> ContactPrep:
    """body_pos/vel/omega (B, N+1, 3), inv_mass (N+1,) or (B, N+1),
    inv_inertia_w (B, N+1, 3, 3).  `inv_mass` / `inv_inertia_w` apply the
    impulses; the effective masses come from `*_eff` where given (the
    split bodies of split_jacobi), else from the same arrays."""
    ia, ib = ct.body_a, ct.body_b
    batch = body_pos.shape[0]

    def per_scene(x):
        return x.expand(batch, -1) if x.dim() == 1 else x

    inv_mass = per_scene(inv_mass)
    im_a, im_b = gather_rows(inv_mass, ia), gather_rows(inv_mass, ib)
    ii_a, ii_b = gather_rows(inv_inertia_w, ia), gather_rows(inv_inertia_w, ib)
    if inv_mass_eff is None:
        im_ea, im_eb = im_a, im_b
    else:
        inv_mass_eff = per_scene(inv_mass_eff)
        im_ea = gather_rows(inv_mass_eff, ia)
        im_eb = gather_rows(inv_mass_eff, ib)
    if inv_inertia_eff is None:
        ii_ea, ii_eb = ii_a, ii_b
    else:
        ii_ea = gather_rows(inv_inertia_eff, ia)
        ii_eb = gather_rows(inv_inertia_eff, ib)

    r_a = ct.point - gather_rows(body_pos, ia)[:, :, None, :]
    r_b = ct.point - gather_rows(body_pos, ib)[:, :, None, :]

    va = gather_rows(vel, ia)[:, :, None, :] + m.cross(
        gather_rows(omega, ia)[:, :, None, :], r_a)
    vb = gather_rows(vel, ib)[:, :, None, :] + m.cross(
        gather_rows(omega, ib)[:, :, None, :], r_b)
    relv = vb - va
    n = ct.normal[:, :, None, :]
    vrel_n = torch.sum(relv * n, dim=-1)
    tangent = m.noz(relv - n * vrel_n[..., None])

    def mv34(mat, v):
        # (B, P, 3, 3) x (B, P, 4, 3) -> (B, P, 4, 3)
        return torch.sum(mat[:, :, None, :, :] * v[:, :, :, None, :], dim=-1)

    def eff(direction):
        cr_a = m.cross(r_a, direction)
        cr_b = m.cross(r_b, direction)
        # Impulses apply at the true inertia ...
        ii_cr_a = mv34(ii_a, cr_a)
        ii_cr_b = mv34(ii_b, cr_b)
        # ... effective masses see the (possibly split) one.
        ii_ecr_a = ii_cr_a if ii_ea is ii_a else mv34(ii_ea, cr_a)
        ii_ecr_b = ii_cr_b if ii_eb is ii_b else mv34(ii_eb, cr_b)
        k = (im_ea[..., None] + torch.sum(cr_a * ii_ecr_a, dim=-1)
             + im_eb[..., None] + torch.sum(cr_b * ii_ecr_b, dim=-1))
        safe = torch.where(k == 0.0, torch.ones_like(k), k)
        eff_mass = torch.where(k != 0.0, 1.0 / safe, torch.zeros_like(k))
        return eff_mass, ii_cr_a, ii_cr_b

    eff_n, n_to_wa, n_to_wb = eff(n.expand(r_a.shape))
    eff_t, t_to_wa, t_to_wb = eff(tangent)

    bias = torch.where(
        (dt > DT_THRESHOLD) & (ct.depth > CONTACT_SLOP) & (vrel_n < 0.0),
        -ct.restitution[..., None] * vrel_n
        + BAUMGARTE_SCALE * (ct.depth - CONTACT_SLOP) / dt,
        torch.zeros_like(vrel_n),
    )

    return ContactPrep(
        r_a=r_a, r_b=r_b, normal=ct.normal, tangent=tangent, bias=bias,
        eff_mass_n=eff_n, eff_mass_t=eff_t,
        n_to_wa=n_to_wa, n_to_wb=n_to_wb, t_to_wa=t_to_wa, t_to_wb=t_to_wb,
        inv_mass_a=im_a, inv_mass_b=im_b, friction=ct.friction,
        pmask=ct.pmask & ct.active[..., None], body_a=ia, body_b=ib,
    )


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def _solve_rows(p: dict, va, wa, vb, wb, imp_n, imp_t):
    """Solve the 4 manifold points of each row in order on local velocity
    copies; `p` holds the color's gathered prep fields.  `imp_n`/`imp_t`
    are the color's own copies and are updated in place."""
    n = p["normal"]
    zero = torch.zeros_like(imp_n[..., 0])
    for k in range(p["pmask"].shape[-1]):
        mask = p["pmask"][..., k]
        r_a, r_b = p["r_a"][..., k, :], p["r_b"][..., k, :]
        t = p["tangent"][..., k, :]

        # Friction first.
        relv = (vb + m.cross(wb, r_b)) - (va + m.cross(wa, r_a))
        vt = torch.sum(relv * t, dim=-1)
        lam = -p["eff_mass_t"][..., k] * vt
        max_f = p["friction"] * imp_n[..., k]
        new_imp = _clip(imp_t[..., k] + lam, -max_f, max_f)
        lam = torch.where(mask, new_imp - imp_t[..., k], zero)
        imp_t[..., k] = torch.where(mask, new_imp, imp_t[..., k])
        pt = lam[..., None] * t
        va = va - p["inv_mass_a"][..., None] * pt
        wa = wa - p["t_to_wa"][..., k, :] * lam[..., None]
        vb = vb + p["inv_mass_b"][..., None] * pt
        wb = wb + p["t_to_wb"][..., k, :] * lam[..., None]

        # Normal.
        relv = (vb + m.cross(wb, r_b)) - (va + m.cross(wa, r_a))
        vn = torch.sum(relv * n, dim=-1)
        lam = -p["eff_mass_n"][..., k] * (vn - p["bias"][..., k])
        new_imp = torch.clamp(imp_n[..., k] + lam, min=0.0)
        lam = torch.where(mask, new_imp - imp_n[..., k], zero)
        imp_n[..., k] = torch.where(mask, new_imp, imp_n[..., k])
        pn = lam[..., None] * n
        va = va - p["inv_mass_a"][..., None] * pn
        wa = wa - p["n_to_wa"][..., k, :] * lam[..., None]
        vb = vb + p["inv_mass_b"][..., None] * pn
        wb = wb + p["n_to_wb"][..., k, :] * lam[..., None]
    return va, wa, vb, wb, imp_n, imp_t


_ROW_FIELDS = ("r_a", "r_b", "normal", "tangent", "bias", "eff_mass_n",
               "eff_mass_t", "n_to_wa", "n_to_wb", "t_to_wa", "t_to_wb",
               "inv_mass_a", "inv_mass_b", "friction", "pmask")


def solve_contacts_colored(prep: ContactPrep, plans: Sequence[ColorPlan],
                           vel, omega, imp_n, imp_t):
    """One Gauss-Seidel sweep over the contact rows, color by color.
    Updates `vel`, `omega`, `imp_n` and `imp_t` (B, ...) in place."""
    for plan in plans:
        p = {f: getattr(prep, f)[:, plan.rows] for f in _ROW_FIELDS}
        va, wa = vel[:, plan.ia], omega[:, plan.ia]
        vb, wb = vel[:, plan.ib], omega[:, plan.ib]
        va, wa, vb, wb, new_n, new_t = _solve_rows(
            p, va, wa, vb, wb, imp_n[:, plan.rows], imp_t[:, plan.rows])
        scatter_bodies(plan, vel, omega, va, wa, vb, wb)
        imp_n[:, plan.rows] = new_n
        imp_t[:, plan.rows] = new_t

