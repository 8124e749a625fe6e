"""Batched Möller-Trumbore intersection + brute-force reference path.

The triangle test mirrors ``util/bvh.hlsl:23-59`` (precomputed ``[e2,e1,v0]``
records, determinant epsilon 1e-7, min distance 1e-4) but evaluates a whole
``(B, M)`` ray x triangle block at once — a dense vector workload, fine
for small scenes and the ground truth the BVH paths are tested against
(SURVEY.md §4).
"""

from __future__ import annotations

import jax.numpy as jnp

from unity_webgpu_pathtracer_tpu.utils.math import FAR_PLANE

DET_EPS = 1e-7
T_MIN = 1e-4


def moller_trumbore(tris: jnp.ndarray, origins: jnp.ndarray, directions: jnp.ndarray):
    """All-pairs triangle test.

    Args: ``tris (M, 9)``, ``origins/directions (B, 3)``.
    Returns ``(t (B,M), u (B,M), v (B,M))`` with ``t=FAR_PLANE`` where invalid.
    """
    e2 = tris[:, 0:3][None]          # (1,M,3)
    e1 = tris[:, 3:6][None]
    v0 = tris[:, 6:9][None]
    o = origins[:, None, :]          # (B,1,3)
    d = directions[:, None, :]

    r = jnp.cross(d, e2)
    a = jnp.sum(e1 * r, axis=-1)
    f = 1.0 / jnp.where(jnp.abs(a) < DET_EPS, 1.0, a)
    s = o - v0
    u = f * jnp.sum(s * r, axis=-1)
    q = jnp.cross(s, e1)
    v = f * jnp.sum(d * q, axis=-1)
    t = f * jnp.sum(e2 * q, axis=-1)

    valid = (
        (jnp.abs(a) > DET_EPS)
        & (u >= 0.0) & (u <= 1.0)
        & (v >= 0.0) & (u + v <= 1.0)
        & (t > T_MIN)
    )
    t = jnp.where(valid, t, FAR_PLANE)
    return t, u, v


def closest_hit_bruteforce(scene, origins: jnp.ndarray, directions: jnp.ndarray):
    """Closest hit over all triangles.

    Returns ``(t, bary (B,2), slot (B,), inst (B,))``; inst is always -1
    (the brute-force path ignores instancing).
    """
    t, u, v = moller_trumbore(scene.tris, origins, directions)
    slot = jnp.argmin(t, axis=-1)
    b = jnp.arange(t.shape[0])
    t_best = t[b, slot]
    bary = jnp.stack([u[b, slot], v[b, slot]], axis=-1)
    slot = jnp.where(t_best < FAR_PLANE, slot, -1).astype(jnp.int32)
    return t_best, bary, slot, jnp.full_like(slot, -1)


def occluded_bruteforce(scene, origins, directions, t_max):
    """Any-hit within ``t_max`` (shadow rays)."""
    t, _, _ = moller_trumbore(scene.tris, origins, directions)
    return jnp.any(t < t_max[:, None], axis=-1)
