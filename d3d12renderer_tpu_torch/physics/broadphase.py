"""Runtime broadphase: batched sweep-and-prune or dense AABB overlap, then
compaction per shape-type combo (counterpart of
``d3d12renderer_tpu/physics/broadphase.py``).

For scenes whose collider pairs are too many to enumerate when the scene
compiles (`SceneBuilder.finalize(broadphase="sap")`):

* "sweep" (`candidate_pairs_swept`): sort colliders by AABB minimum along
  the axis of largest centre variance, test each against the next W in
  sorted order (W = `sap_neighbors`), keep at most `sap_row_cap` partners
  per collider.  Overflow counts colliders whose window ended while the
  sweep still overlapped, and colliders with more partners than the cap.
* "dense" (`candidate_pairs`): all-pairs AABB mask and the first
  `sap_neighbors` partners of each collider.

The candidates are compacted per (type_a, type_b) combo so that each
narrowphase runs on rows of its own combo, and after the narrowphase the
table is compacted to its active rows (`compact_active`).  Every selection
takes JAX's `lax.top_k` order: scores descending, ties by lower index, the
order of a stable descending sort.  Every tensor has a leading scene axis
B; where the JAX package permutes into sorted order and takes shifted
slices (gathers serialise on its TPU), the port gathers with the sorted
window's indices.
"""

from __future__ import annotations

import torch

from ..core import maths as m
from . import collide, narrow
from .narrow import ContactTable
from .types import SHAPE_BOX, SHAPE_SPHERE, BodyState, SceneArchetype


def top_k(score, k: int):
    """(values, indices) of the k largest along the last axis; ties keep
    their lower indices first (JAX's `lax.top_k`)."""
    vals, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def world_aabbs(arch: SceneArchetype, wpos, wrot):
    """Per-collider world AABBs (B, C, 3) min / max: exact for spheres and
    boxes, bound-radius cubes for capsules, cylinders and hulls (extra
    candidates, never a missed one)."""
    t = arch.col_type[:, None]
    size = arch.col_size
    box_ext = m.mat3_vec(torch.abs(m.quat_to_mat3(wrot)), size)
    ext = torch.where(t == SHAPE_SPHERE, size[:, :1].expand(size.shape),
                      torch.where(t == SHAPE_BOX, box_ext,
                                  arch.col_bound_radius[:, None].expand(
                                      size.shape)))
    return wpos - ext, wpos + ext


def _sorted_window(c: int, w: int, device):
    """(C, W) sorted positions i + 1 .. i + W, clamped to the last."""
    pos = torch.arange(c, device=device)[:, None] + torch.arange(
        1, w + 1, device=device)[None, :]
    return torch.clamp(pos, max=c - 1), pos < c


def candidate_pairs_swept(arch: SceneArchetype, amin, amax):
    """Sweep-and-prune candidates of AABBs (B, C, 3).  Returns (i_idx,
    j_idx, valid) (B, C, K), K = min(W, sap_row_cap) (W where the cap is 0
    or at least W), and the overflow count (B,)."""
    batch, c, _ = amin.shape
    dev = amin.device
    w = min(arch.sap_neighbors, max(c - 1, 1))
    centers = 0.5 * (amin + amax)
    axis = torch.argmax(torch.var(centers, dim=1, correction=0), dim=-1)
    ax = axis[:, None, None].expand(batch, c, 1)
    amin_ax = torch.gather(amin, 2, ax)[..., 0]
    amax_ax = torch.gather(amax, 2, ax)[..., 0]
    order = torch.argsort(amin_ax, dim=-1, stable=True)          # (B, C)

    def sort3(x):
        return torch.gather(x, 1, order[..., None].expand(batch, c, 3))

    amin_s, amax_s = sort3(amin), sort3(amax)
    amin_ax_s = torch.gather(amin_ax, 1, order)
    amax_ax_s = torch.gather(amax_ax, 1, order)
    bodies = arch.col_body[order]                                 # (B, C)
    kin_s = arch.sap_body_kinematic[bodies]
    grp_s = arch.sap_body_group[bodies]

    win, in_range = _sorted_window(c, w, dev)                     # (C, W)
    amin_j, amax_j = amin_s[:, win], amax_s[:, win]               # (B, C, W, 3)
    bodies_j = bodies[:, win]
    oj = order[:, win]

    sweep_ok = amin_ax_s[:, win] <= amax_ax_s[..., None]
    overlap = torch.all(torch.maximum(amin_s[:, :, None], amin_j)
                        <= torch.minimum(amax_s[:, :, None], amax_j), dim=-1)
    # Admissibility from the per-body attributes (builder._collides).
    bi = bodies[..., None]
    grp_i = grp_s[..., None]
    collidable = ((bi != bodies_j) & ~(kin_s[..., None] & kin_s[:, win])
                  & ~((grp_i >= 0) & (grp_i == grp_s[:, win])))
    excl = arch.sap_joint_excl
    if excl.shape[0] > 0:
        slots = arch.num_bodies + 1
        key = torch.minimum(bi, bodies_j) * slots + torch.maximum(bi, bodies_j)
        collidable &= ~torch.isin(key, excl[:, 0] * slots + excl[:, 1])
    valid = in_range & sweep_ok & overlap & collidable

    # A collider whose window ended while the sweep still held: the next
    # sorted collider past the window starts before this one ends.
    i_pos = torch.arange(c, device=dev)
    nxt = torch.clamp(i_pos + (min(w + 1, c - 1) if c > 1 else 0), max=c - 1)
    spill = (i_pos + w + 1 < c) & (amin_ax_s[:, nxt] <= amax_ax_s)
    overflow = torch.sum(spill, dim=-1)
    i_idx = order[..., None].expand(batch, c, w)

    # At most `cap` partners per collider, the nearest in sorted order.
    cap = arch.sap_row_cap or 0
    if 0 < cap < w:
        rscore = torch.where(valid, w - torch.arange(w, device=dev), 0)
        vals, selw = top_k(rscore, cap)
        overflow = overflow + torch.sum(torch.sum(valid, -1) > cap, dim=-1)
        i_idx = torch.gather(i_idx, -1, selw)
        oj = torch.gather(oj, -1, selw)
        valid = vals > 0
    return i_idx, oj, valid, overflow


def candidate_pairs(arch: SceneArchetype, amin, amax):
    """Dense candidates of AABBs (B, C, 3): row i's first K =
    sap_neighbors admissible AABB partners j > i.  Returns (j_idx, valid)
    (B, C, K) and the count (B,) of rows with more than K partners."""
    k = arch.sap_neighbors
    c = amin.shape[-2]
    lo = torch.maximum(amin[:, :, None], amin[:, None])
    hi = torch.minimum(amax[:, :, None], amax[:, None])
    mask = torch.all(lo <= hi, dim=-1) & arch.sap_collidable
    score = torch.where(mask, c - torch.arange(c, device=amin.device), 0)
    vals, j_idx = top_k(score, k)
    overflow = torch.sum(torch.sum(mask, -1) > k, dim=-1)
    return j_idx, vals > 0, overflow


def _candidates(arch: SceneArchetype, amin, amax):
    """(i_idx, j_idx, valid, overflow) of the archetype's algorithm."""
    if arch.sap_mode == "sweep":
        return candidate_pairs_swept(arch, amin, amax)
    j_idx, valid, overflow = candidate_pairs(arch, amin, amax)
    i_idx = torch.arange(j_idx.shape[-2], device=j_idx.device)[:, None]
    return i_idx.expand(j_idx.shape), j_idx, valid, overflow


def sap_manifolds(arch: SceneArchetype, wpos, wrot) -> ContactTable:
    """Contact table of the runtime candidate pairs: one part per type
    combo of `sap_max_contacts // combos` rows, body indices (B, P)."""
    amin, amax = world_aabbs(arch, wpos, wrot)
    i_idx, j_idx, valid, _ = _candidates(arch, amin, amax)
    batch = wpos.shape[0]
    ia = i_idx.reshape(batch, -1)
    ib = j_idx.reshape(batch, -1)
    valid = valid.reshape(batch, -1)

    # Canonical type order within each pair (type_a <= type_b).
    ta, tb = arch.col_type[ia], arch.col_type[ib]
    swap = ta > tb
    ia, ib = torch.where(swap, ib, ia), torch.where(swap, ia, ib)
    ta, tb = torch.where(swap, tb, ta), torch.where(swap, ta, tb)

    # Two stages: the first budget_all valid rows of the whole table, then
    # each combo's first rows of those.
    p0 = ia.shape[-1]
    combos = max(len(arch.sap_type_pairs), 1)
    budget_all = min(arch.sap_max_contacts, p0)
    combo_budget = max(budget_all // combos, 1)
    if p0 > 2 * budget_all:
        rank0 = p0 - torch.arange(p0, device=ia.device)
        _, sel0 = top_k(torch.where(valid, rank0, 0), budget_all)
        ia, ib, valid, ta, tb = (torch.gather(x, -1, sel0)
                                 for x in (ia, ib, valid, ta, tb))
        p0 = budget_all
    rank = p0 - torch.arange(p0, device=ia.device)

    parts = []
    for (tta, ttb) in arch.sap_type_pairs:
        combo = valid & (ta == tta) & (tb == ttb)
        vals, sel = top_k(torch.where(combo, rank, 0), combo_budget)
        ia_c, ib_c = torch.gather(ia, -1, sel), torch.gather(ib, -1, sel)

        def at(x, idx):
            return torch.gather(x, 1, idx[..., None].expand(
                idx.shape + (x.shape[-1],)))

        normal, pts, dep, msk = collide.pair_narrow_dispatch(
            arch, ia_c, ib_c, tta, ttb, at(wpos, ia_c), at(wrot, ia_c),
            at(wpos, ib_c), at(wrot, ib_c))
        msk = msk & (vals > 0)[..., None]
        friction, restitution = narrow.combine_materials(
            arch.col_friction[ia_c], arch.col_friction[ib_c],
            arch.col_restitution[ia_c], arch.col_restitution[ib_c])
        parts.append(ContactTable(
            body_a=arch.col_body[ia_c], body_b=arch.col_body[ib_c],
            normal=normal, point=pts, depth=dep, pmask=msk,
            friction=friction, restitution=restitution,
            active=torch.any(msk, dim=-1)))
    return parts[0] if len(parts) == 1 else collide._concat_tables(parts)


def compact_active(contacts: ContactTable, budget: int) -> ContactTable:
    """The first `budget` rows of a table with (B, P) body indices, active
    rows first, each group in row order.  Rows past `budget` active ones
    are dropped: size the budget from the scene."""
    p0 = contacts.active.shape[-1]
    if budget >= p0:
        return contacts
    score = torch.where(contacts.active,
                        p0 - torch.arange(p0, device=contacts.active.device), 0)
    _, sel = top_k(score, budget)

    def take(x):
        idx = sel.reshape(sel.shape + (1,) * (x.dim() - 2))
        return torch.gather(x, 1, idx.expand(sel.shape + x.shape[2:]))

    return ContactTable(**{f: take(getattr(contacts, f))
                           for f in ContactTable.__dataclass_fields__})


def overflow_count(arch: SceneArchetype, state: BodyState):
    """Per scene (B,): colliders whose candidate set was cut this step (the
    sweep window or the row cap for "sweep", K for "dense")."""
    wpos, wrot = collide.collider_world_poses(arch, state)
    return _candidates(arch, *world_aabbs(arch, wpos, wrot))[3]
