"""The XLA wide16 arrival (``ops.traverse_wide16.arrival_step16``), the
fused integrator's traversal on every backend, run to completion against
a float64 NumPy brute-force closest hit, plain and instanced, at pool
sizes that are and are not multiples of 1024; and the freeze contract of
inactive lanes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from unity_webgpu_pathtracer_tpu.accel.wide16 import (
    build_scene_wide16,
    build_tlas_wide16,
)
from unity_webgpu_pathtracer_tpu.ops import traverse_wide16 as tw16
from unity_webgpu_pathtracer_tpu.utils.math import FAR_PLANE, safe_rcp

from tests.test_wide8 import random_rays, random_tris, recs_of

POOLS = (1000, 1024, 1280, 2048, 4608)


def bruteforce_f64(world_tris, o, d):
    """Closest Möller-Trumbore hit over every triangle, float64:
    ``(t, triangle index)``, index -1 on a miss."""
    o = np.asarray(o, np.float64)
    d = np.asarray(d, np.float64)
    v0, v1, v2 = (world_tris[:, i].astype(np.float64) for i in range(3))
    e1, e2 = v1 - v0, v2 - v0
    best_t = np.full(o.shape[0], np.inf)
    best_i = np.full(o.shape[0], -1)
    for lo in range(0, o.shape[0], 256):
        oo, dd = o[lo:lo + 256, None], d[lo:lo + 256, None]
        p = np.cross(dd, e2[None])
        det = (e1[None] * p).sum(-1)
        ok = np.abs(det) > 1e-12
        inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
        s = oo - v0[None]
        u = (s * p).sum(-1) * inv
        q = np.cross(s, e1[None])
        v = (dd * q).sum(-1) * inv
        t = (e2[None] * q).sum(-1) * inv
        hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-4)
        t = np.where(hit, t, np.inf)
        i = t.argmin(axis=1)
        tb = t[np.arange(t.shape[0]), i]
        best_t[lo:lo + 256] = tb
        best_i[lo:lo + 256] = np.where(np.isfinite(tb), i, -1)
    return best_t, best_i


def _plain_scene():
    tris = random_tris(1500, seed=31)
    w = build_scene_wide16(tris, recs_of(tris))
    nodes = jnp.asarray(w.nodes)
    order = np.asarray(w.order)
    # A hit's attr row is a BVH-order ref; order[] maps it to the input tri.
    return nodes, tris, lambda tri, inst: np.where(tri >= 0,
                                                   order[np.maximum(tri, 0)],
                                                   -1), False


def _instanced_scene():
    base = random_tris(300, seed=9, spread=1.0, size=0.3)
    w = build_scene_wide16(base, recs_of(base))
    p = base.reshape(-1, 3)
    t1 = np.eye(4, dtype=np.float32)
    t2 = np.eye(4, dtype=np.float32)
    t2[:3, 3] = (2.5, 0.5, -1.0)
    t2[0, 0] = 1.5  # non-uniform scale: the unnormalized-direction trick
    table, _l2w, _w2l, _layout = build_tlas_wide16(
        [w], [(p.min(0), p.max(0))], [(0, t1, None), (0, t2, None)], [0])
    world2 = (base.reshape(-1, 3) @ t2[:3, :3].T + t2[:3, 3]).reshape(
        base.shape).astype(np.float32)
    world = np.concatenate([base, world2])
    order = np.asarray(w.order)

    def ids(tri, inst):
        return np.where(tri >= 0, order[np.maximum(tri, 0)]
                        + base.shape[0] * np.maximum(inst, 0), -1)

    return jnp.asarray(table.nodes), world, ids, True


SCENES = {"plain": _plain_scene, "instanced": _instanced_scene}


@pytest.fixture(scope="module")
def scenes():
    return {k: f() for k, f in SCENES.items()}


def _run_to_completion(nodes, o, d, has_instances):
    inv = safe_rcp(d)
    s = tw16.init_state16(o.shape[0], jnp.float32(FAR_PLANE))
    s = jax.lax.while_loop(
        lambda s: jnp.any(s.ptr >= 0),
        lambda s: tw16.arrival_step16(nodes, o, d, inv, s, None,
                                      has_instances=has_instances), s)
    return s


@pytest.mark.parametrize("kind", sorted(SCENES))
@pytest.mark.parametrize("pool", POOLS)
def test_arrival_to_completion_matches_numpy(scenes, kind, pool):
    nodes, world, ids, has_inst = scenes[kind]
    o, d = random_rays(pool, seed=pool, spread=4.0, tris=world)
    s = jax.jit(_run_to_completion, static_argnums=(3,))(nodes, o, d,
                                                         has_inst)
    t_ref, i_ref = bruteforce_f64(world, o, d)
    got = ids(np.asarray(s.tri), np.asarray(s.hit_inst))
    hit, hit_ref = got >= 0, i_ref >= 0
    # f16 leaf records shift grazing hits; nothing else may differ.
    assert (hit == hit_ref).mean() >= 0.99
    both = hit & hit_ref
    assert both.sum() > pool // 4
    assert (got[both] == i_ref[both]).mean() >= 0.99
    rel = np.abs(np.asarray(s.t)[both] - t_ref[both]) / t_ref[both]
    assert np.quantile(rel, 0.98) < 5e-3
    assert np.all(np.asarray(s.ptr) < 0)


@pytest.mark.parametrize("kind", sorted(SCENES))
@pytest.mark.parametrize("steps", [1, 6])
def test_inactive_lanes_stay_frozen(scenes, kind, steps):
    """Lanes outside ``active`` keep every register bit for bit, while
    active lanes advance."""
    nodes, world, _ids, has_inst = scenes[kind]
    b = 1280
    o, d = random_rays(b, seed=3, spread=4.0, tris=world)
    inv = safe_rcp(d)
    active = jnp.asarray(np.random.default_rng(4).random(b) < 0.5)
    s0 = tw16.init_state16(b, jnp.float32(FAR_PLANE))

    def run(s):
        for _ in range(steps):
            s = tw16.arrival_step16(nodes, o, d, inv, s, active,
                                    has_instances=has_inst)
        return s

    s1 = jax.jit(run)(s0)
    act = np.asarray(active)
    for name in ("ptr", "pend", "sp", "t", "u", "v", "tri", "found", "inst",
                 "hit_inst", "sp_enter"):
        a0 = np.asarray(getattr(s0, name))
        a1 = np.asarray(getattr(s1, name))
        assert np.array_equal(a0[~act].view(np.uint8),
                              a1[~act].view(np.uint8)), name
    for name in ("stack_row", "stack_mask"):
        a0 = np.asarray(getattr(s0, name))
        a1 = np.asarray(getattr(s1, name))
        assert np.array_equal(a0[:, ~act], a1[:, ~act]), name
    assert not np.array_equal(np.asarray(s1.ptr)[act],
                              np.asarray(s0.ptr)[act])
