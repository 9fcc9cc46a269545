"""Linear-blend vertex skinning (counterpart of
``d3d12renderer_tpu/animation/skinning.py``; reference
src/animation/skinning.h:15-22, skinning.cpp:235): 4 influences per vertex,
gathers and products over the whole vertex set at once, with leading batch
axes on the joint transforms for a crowd.
"""

from __future__ import annotations

import torch

from ..core import maths as m


def skin_vertices(positions, normals, joint_indices, joint_weights,
                  joint_pos, joint_rot):
    """positions / normals (V, 3); joint_indices (V, 4); joint_weights
    (V, 4) summing to 1; joint_pos / joint_rot (..., J, 3) / (..., J, 4),
    bind -> world (`animation.skinning_transforms`).  (pos, normal)
    (..., V, 3), the normals normalized or zero."""
    idx = joint_indices.long()
    jp = joint_pos[..., idx, :]                    # (..., V, 4, 3)
    jr = joint_rot[..., idx, :]                    # (..., V, 4, 4)
    p = positions[:, None, :]
    n = normals[:, None, :]
    skinned_p = jp + m.quat_rotate(jr, p)
    skinned_n = m.quat_rotate(jr, n)
    w = joint_weights[..., None]
    out_p = torch.sum(skinned_p * w, dim=-2)
    out_n = m.noz(torch.sum(skinned_n * w, dim=-2))
    return out_p, out_n


def skin_meshes(batch):
    """Skin a list of (positions, normals, indices4, weights4, jpos, jrot);
    a list of (pos, normal)."""
    return [skin_vertices(p, n, ji, jw, jp, jr)
            for (p, n, ji, jw, jp, jr) in batch]
