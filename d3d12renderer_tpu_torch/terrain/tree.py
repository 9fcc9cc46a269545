"""Trees (counterpart of ``d3d12renderer_tpu/terrain/tree.py``): the wind
bend of vertex positions, and the weld of an imported mesh's vertices
(scipy's cKDTree and a union-find that roots each component at its least
index)."""

from __future__ import annotations

import numpy as np
import torch


def wind_bend(positions, time, trunk_height=3.0, strength=0.15,
              frequency=0.9):
    """Positions (..., 3) displaced by a sway that grows with the square
    of the normalised height."""
    y01 = torch.clamp(positions[..., 1] / trunk_height, 0.0, 1.0)
    phase = positions[..., 0] * 0.31 + positions[..., 2] * 0.47
    sway = torch.sin(time * frequency + phase) + 0.4 * torch.sin(
        time * frequency * 2.33 + phase * 1.3)
    amp = strength * y01 * y01
    off = torch.stack([sway * amp, torch.zeros_like(amp), 0.6 * sway * amp],
                      -1)
    return positions + off


def weld_vertices(positions: np.ndarray, indices: np.ndarray,
                  tolerance: float = 1e-4):
    """Merge vertices closer than `tolerance`.  Returns (positions',
    indices', remap)."""
    from scipy.spatial import cKDTree

    pairs = cKDTree(positions).query_pairs(tolerance, output_type="ndarray")
    parent = np.arange(len(positions))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for a, b in pairs:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
    remap = np.array([find(i) for i in range(len(positions))], np.int64)
    used, inverse = np.unique(remap, return_inverse=True)
    return (positions[used], inverse[remap[indices]].astype(np.int32),
            inverse[remap])
