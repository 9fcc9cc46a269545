"""Bitonic key-value sort with its self-test (counterpart of
``d3d12renderer_tpu/render/sort.py``): the bitonic network itself over a
power-of-two array padded with +inf (-inf descending) sentinels, one
compare-exchange stage per (size, stride).  Its order among equal keys is
the network's (every dead particle has key +inf), which `torch.sort` does
not reproduce."""

from __future__ import annotations

import numpy as np
import torch


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def bitonic_sort_kv(keys, values, descending: bool = False):
    """(keys, values) sorted by keys through the bitonic network."""
    n = keys.shape[0]
    p = _next_pow2(n)
    big = -torch.inf if descending else torch.inf
    k = torch.cat([keys, keys.new_full((p - n,), big)])
    v = torch.cat([values, values.new_zeros((p - n,))])
    idx = torch.arange(p, device=keys.device)
    size = 2
    while size <= p:
        stride = size // 2
        while stride > 0:
            partner = idx ^ stride
            ascend = (idx & size) == 0
            if descending:
                ascend = ~ascend
            k_p, v_p = k[partner], v[partner]
            keep = torch.where(
                idx < partner,
                torch.where(ascend, k <= k_p, k >= k_p),
                torch.where(ascend, k >= k_p, k <= k_p))
            k = torch.where(keep, k, k_p)
            v = torch.where(keep, v, v_p)
            stride //= 2
        size *= 2
    return k[:n], v[:n]


def sort_particles_by_depth(positions, camera_position, alive):
    """Back-to-front particle order: farthest first, dead last."""
    d = torch.linalg.norm(positions - camera_position, dim=-1)
    key = torch.where(alive, -d, torch.inf)
    _, order = bitonic_sort_kv(key, torch.arange(
        positions.shape[0], dtype=torch.int32, device=positions.device))
    return order


def self_test(num_elements: int = 1000, descending: bool = False,
              seed: int = 0, device="cpu") -> bool:
    """The network against numpy's sort on seeded normal keys: sorted keys
    equal, and the values the permutation that sorts them."""
    rng = np.random.default_rng(seed)
    keys = rng.normal(size=num_elements).astype(np.float32)
    vals = np.arange(num_elements, dtype=np.int32)
    k, v = bitonic_sort_kv(torch.as_tensor(keys, device=device),
                           torch.as_tensor(vals, device=device),
                           descending=descending)
    k, v = k.cpu().numpy(), v.cpu().numpy()
    ref = np.sort(keys)[::-1] if descending else np.sort(keys)
    return bool(np.allclose(k, ref)) and bool(np.allclose(keys[v], k))
