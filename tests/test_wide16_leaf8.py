"""wide16 leaf8 variant (48-float rows, 8-triangle leaves): build
invariants and traversal equivalence.

The full wide16 suite also passes wholesale under ``UWPT_WIDE16_LEAF8=1``;
these tests pin the variant explicitly so CI covers it by default.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from unity_webgpu_pathtracer_tpu.accel.wide16 import (
    LEAF8,
    ROW8,
    build_scene_wide16,
    build_wide16,
    validate_wide16,
)
from unity_webgpu_pathtracer_tpu.ops import traverse_wide16 as tw16
from unity_webgpu_pathtracer_tpu.ops.intersect import closest_hit_bruteforce
from unity_webgpu_pathtracer_tpu.utils.math import FAR_PLANE, safe_rcp

from tests.test_wide8 import random_rays, random_tris, recs_of


class Leaf8Scene:
    def __init__(self, tris, quality=1):
        recs = recs_of(tris)
        self.w16 = build_scene_wide16(tris, recs, quality=quality, leaf8=True)
        assert self.w16.nodes.shape[1] == ROW8
        self.wide16_nodes = jnp.asarray(self.w16.nodes)
        self.order = np.asarray(self.w16.order)
        self.tris = jnp.asarray(recs[self.w16.order])
        self.tri_index = jnp.arange(self.order.shape[0], dtype=jnp.int32)
        self.inst_w2l = jnp.zeros((0, 12), jnp.float32)


@pytest.mark.parametrize("n", [12, 300, 4000])
def test_leaf8_build_valid(n):
    tris = random_tris(n, seed=n)
    w = build_scene_wide16(tris, recs_of(tris), leaf8=True)
    validate_wide16(w, n)
    # Every leaf respects the 8-slot cap.
    meta = w.nodes[:, 3].view(np.int32)
    assert meta.max() <= LEAF8


def test_leaf8_numpy_build_valid():
    from unity_webgpu_pathtracer_tpu.accel.bvh2 import build_bvh2

    tris = random_tris(700, seed=9)
    bvh = build_bvh2(tris, leaf_size=4)
    w = build_wide16(bvh, recs_of(tris),
                     np.arange(700, dtype=np.int32), leaf8=True)
    assert w.nodes.shape[1] == ROW8
    validate_wide16(w, 700)


@pytest.mark.parametrize("n,thresh", [(300, 0.995), (4000, 0.995)])
def test_leaf8_matches_bruteforce(n, thresh):
    tris = random_tris(n, seed=n + 7)
    scene = Leaf8Scene(tris)
    o, d = random_rays(512, seed=n, tris=tris)
    t16, _bary, slot16, _ = tw16.closest_hit(scene, o, d)
    tb, _baryb, slotb, _ = closest_hit_bruteforce(scene, o, d)
    hit16 = np.asarray(slot16) >= 0
    hitb = np.asarray(slotb) >= 0
    id16 = scene.order[np.maximum(np.asarray(slot16), 0)]
    idb = scene.order[np.maximum(np.asarray(slotb), 0)]
    same = (hit16 == hitb) & (~hitb | (id16 == idb))
    assert same.mean() >= thresh, f"only {same.mean():.4f} agree"


def test_leaf8_tlas_instanced_build():
    """Two-level leaf8 build: the unified 48-float table traverses
    instances correctly (spinning-quads fixture geometry)."""
    from unity_webgpu_pathtracer_tpu.accel.wide16 import build_tlas_wide16
    from unity_webgpu_pathtracer_tpu.accel.wide8 import _subtree_ranges  # noqa: F401

    tris = random_tris(200, seed=3)
    recs = recs_of(tris)
    blas = [build_scene_wide16(tris, recs, quality=0, leaf8=True)]
    p = tris.reshape(-1, 3)
    bounds = [(p.min(0), p.max(0))]
    eye = np.eye(4, dtype=np.float32)
    shift = eye.copy()
    shift[0, 3] = 5.0
    inst = [(0, eye, -1), (0, shift, -1)]
    w, l2w, w2l, layout = build_tlas_wide16(blas, bounds, inst,
                                            attr_bases=[0])
    assert w.nodes.shape[1] == ROW8
    # Both instances' subtrees reachable: trace rays at each copy.
    class S:
        wide16_nodes = jnp.asarray(w.nodes)
        order = np.asarray(blas[0].order)
        tris_j = jnp.asarray(recs[blas[0].order])
        inst_w2l = jnp.asarray(w2l)

    o, d = random_rays(256, seed=4, tris=tris)
    s = tw16.init_state16(256, jnp.float32(FAR_PLANE), depth=16)
    oj, dj = jnp.asarray(o), jnp.asarray(d)
    inv = safe_rcp(dj)
    for _ in range(200):
        s = tw16.arrival_step16(S.wide16_nodes, oj, dj, inv, s,
                                None, has_instances=True)
    assert bool((np.asarray(s.ptr) < 0).all()), "traversal did not finish"
    # The same rays against the untransformed single mesh must agree on
    # the identity-instance copy's hits.
    sc0 = Leaf8Scene(tris, quality=0)
    t0, _b, slot0, _ = tw16.closest_hit(sc0, o, d)
    hit_inst0 = np.asarray(s.hit_inst) == 0
    both = hit_inst0 & (np.asarray(slot0) >= 0)
    assert both.any()
    assert np.allclose(np.asarray(s.t)[both], np.asarray(t0)[both],
                       rtol=1e-4, atol=1e-4)
