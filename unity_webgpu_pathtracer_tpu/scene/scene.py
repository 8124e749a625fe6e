"""Scene container: host-side assembly -> flat device arrays.

``Scene`` plays the role of the reference's ``BVHScene``
(``Assets/Scripts/util/BVHScene.cs``): it gathers meshes, packs
materials/textures/lights, drives the BVH/TLAS build and owns the flat
arrays the integrator consumes.  ``SceneData`` is the device-side pytree —
the analogue of the bound GPU buffers (``BVHScene.PrepareShader``,
``BVHScene.cs:140-167``) — with static shapes so it jits cleanly.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from unity_webgpu_pathtracer_tpu.scene import lights as ulights
from unity_webgpu_pathtracer_tpu.scene import material as umaterial
from unity_webgpu_pathtracer_tpu.scene import texture as utexture
from unity_webgpu_pathtracer_tpu.scene.envmap import EnvMap, build_envmap, empty_envmap
from unity_webgpu_pathtracer_tpu.scene.mesh import FlatTriangles, Mesh, concat_flat, flatten_mesh


def _z(*shape, dtype=jnp.float32):
    return jnp.zeros(shape, dtype)


def _pack_attr_shade(normals9: np.ndarray, uvs6: np.ndarray,
                     material: np.ndarray) -> np.ndarray:
    """Per-triangle shading rows [normals 9 | uvs 6 | material(int) 1],
    grouped THREE triangles per 192-byte device row (one wide gather
    instead of three narrow ones): triangle ``t`` lives in row ``t//3``
    at sub-slot ``t%3`` and the consumer selects the 16-float slice."""
    t = normals9.shape[0]
    flat = np.zeros((t, 16), np.float32)
    flat[:, 0:9] = normals9
    flat[:, 9:15] = uvs6
    flat[:, 15] = material.astype(np.int32).view(np.float32)
    rows = (t + 2) // 3
    out = np.zeros((rows * 3, 16), np.float32)
    out[:t] = flat
    return out.reshape(rows, 48)


def _pack_attr_shade_c(normals9: np.ndarray, uvs6: np.ndarray,
                       material: np.ndarray) -> np.ndarray:
    """Compact 32-byte per-triangle shading rows: 15 f16 halfwords
    [normals 9 | uvs 6] + one u16 material index, little-endian-packed
    into 8 uint32 words.  Halving the row halves the table footprint the
    random attr gather reads from; precision cost is ~1e-3 on unit
    normals and ~5e-4 on uvs (≤1 texel at 2k).  Consumed by the fused
    integrator when ``config.attr_compact`` is set.

    Stored (T_pad, 8); the production mode-2 path reshapes to (T_pad/2,
    16) inside the render loop (or once, at loop entry, with
    ``config.attr_carry``)."""
    t = normals9.shape[0]
    # Pad to a multiple of 6 triangles so rows pair cleanly.
    h = np.zeros((((t + 5) // 6) * 6, 16), np.uint16)
    h[:t, 0:9] = normals9.astype(np.float16).view(np.uint16)
    h[:t, 9:15] = np.clip(uvs6, -65504, 65504).astype(np.float16).view(np.uint16)
    m = material.astype(np.int64)
    _check_u16_materials(m)
    h[:t, 15] = m.astype(np.uint16)
    return np.ascontiguousarray(h).view(np.uint32)   # (T_pad, 8)


class _MaterialRangeError(ValueError):
    """Material index does not fit the u16 field of a compact attr row."""


def _check_u16_materials(m: np.ndarray) -> None:
    if m.size and (m.max() > 0xFFFF or m.min() < 0):
        raise _MaterialRangeError(
            "attr_compact supports at most 65536 materials")


def _pack_or_placeholder(pack_fn, placeholder, *args):
    """Build a compact attr table, degrading to the SceneData placeholder
    (with a warning) when the material count exceeds the u16 row field —
    scenes that never render with ``config.attr_compact`` set must not be
    aborted by a table they will not read.  The fused integrator re-checks
    at trace time and raises there with a config-level message."""
    try:
        return pack_fn(*args)
    except _MaterialRangeError as e:
        import warnings

        warnings.warn(f"{e}; compact attr table degraded to placeholder "
                      "(rendering with config.attr_compact set will fail)",
                      stacklevel=2)
        return np.asarray(placeholder)


def _sign_not_zero(x: np.ndarray) -> np.ndarray:
    return np.where(x >= 0.0, 1.0, -1.0).astype(np.float32)


def _oct_encode_u32(normals: np.ndarray) -> np.ndarray:
    """(N, 3) normals -> one u32 each: 16-bit octahedral (x | y<<16).

    Max angular error ~1/32768 rad — an order tighter than the f16
    component encoding it replaces.  Zero vectors map to the +z pole.
    """
    n = np.asarray(normals, np.float32)
    denom = np.maximum(np.abs(n).sum(axis=1, keepdims=True), 1e-20)
    p = n[:, 0:2] / denom
    neg = n[:, 2] < 0.0
    folded = (1.0 - np.abs(p[:, ::-1])) * _sign_not_zero(p)
    p = np.where(neg[:, None], folded, p)
    q = np.clip(np.round((p * 0.5 + 0.5) * 65535.0), 0, 65535).astype(np.uint32)
    return q[:, 0] | (q[:, 1] << np.uint32(16))


def _pack_attr_shade_o(normals9: np.ndarray, material: np.ndarray) -> np.ndarray:
    """Ultra-compact 16-byte per-triangle shading rows for UNTEXTURED
    scenes: three 16-bit-octahedral vertex normals + the material index,
    4 u32 words per triangle, FOUR triangles per stored 64-byte row (the
    same gathered row width as mode 2).  Quarter the mode-2 footprint:
    16 MB at 1M tris.  uv is NOT stored: with ``has_textures=False`` the
    interpolated uv feeds nothing (derive_material only reads it for
    texture fetches), so the fused integrator's mode-3 path statically
    requires untextured configs.
    """
    t = normals9.shape[0]
    pad = ((t + 3) // 4) * 4
    out = np.zeros((pad, 4), np.uint32)
    n = np.asarray(normals9, np.float32).reshape(t, 3, 3)
    for v in range(3):
        out[:t, v] = _oct_encode_u32(n[:, v])
    m = material.astype(np.int64)
    _check_u16_materials(m)
    out[:t, 3] = m.astype(np.uint32)
    return np.ascontiguousarray(out)   # (T_pad, 4)


class SceneData(NamedTuple):
    """Device-resident flat scene arrays (all shapes static).

    Acceleration/auxiliary fields default to empty placeholders so partial
    scenes (tests, single-backend builds) stay cheap pytrees.
    """

    # Geometry: [e2,e1,v0] records + per-triangle attributes.
    tris: jnp.ndarray            # (M, 9) float32
    tri_index: jnp.ndarray       # (M,) int32 -> attribute row (BVH reorders)
    attr_normals: jnp.ndarray    # (T, 9) float32 (3 vertices x 3)
    attr_tangents: jnp.ndarray   # (T, 9)
    attr_uvs: jnp.ndarray        # (T, 6)
    attr_material: jnp.ndarray   # (T,) int32

    # Shading tables.
    materials: jnp.ndarray       # (NM, 32) float32
    texture_data: jnp.ndarray    # (K,) uint32 atlas
    lights: jnp.ndarray          # (L, 16) float32
    env: EnvMap

    # Packed per-triangle shading rows [normals 9 | uvs 6 | material(int) 1]
    # x3 triangles per row: the fused integrator's transitions fetch ONE
    # 192-byte row instead of three separate gathers.
    attr_shade: jnp.ndarray = _z(1, 48)       # (ceil(T/3), 48) float32

    # Compact half of the same table: 32-byte rows (15 f16 + u16 material
    # packed into 8 u32 words, one triangle per row), half the footprint;
    # the integrator reads this when ``config.attr_compact`` is set.  The
    # production mode-2 consumer reshapes to (-1, 16), see
    # ``_pack_attr_shade_c``.
    # (placeholder is (2, 8) so the mode-2 (-1, 16) reshape stays valid)
    attr_shade_c: jnp.ndarray = _z(2, 8, dtype=jnp.uint32)  # (6*ceil(T/6), 8)

    # Ultra-compact 16-byte rows (mode 3, untextured scenes): 3 oct16x2
    # vertex normals + material, four tris per gathered 64-byte row
    # (``_pack_attr_shade_o``).  Placeholder (4, 4) keeps the consumer's
    # (-1, 16) reshape valid.
    attr_shade_o: jnp.ndarray = _z(4, 4, dtype=jnp.uint32)  # (4*ceil(T/4), 4)

    # 8-wide MBVH (SoA): bounds laid out [lox·8, loy·8, loz·8, hix·8, hiy·8, hiz·8].
    bvh_bounds: jnp.ndarray = _z(1, 48)       # (N, 48) float32
    bvh_child: jnp.ndarray = _z(1, 8, dtype=jnp.int32)  # (N, 8) int32

    # Skip-pointer linearized BVH2 (accel.linearize), one DFS order per ray
    # octant (ops.traverse_skip).
    skip_nodes: jnp.ndarray = _z(1, 1, 8)     # (O, N2, 8) float32

    # Fat-row 4-ary BVH with inline leaf triangles (accel.wide), one gather
    # per arrival (ops.traverse_wide).
    wide_nodes: jnp.ndarray = _z(1, 1, 48)    # (O, N4, 48) float32

    # 8-wide quantized stack format (accel.wide8 / ops.traverse_wide8) —
    # the mid-tier format: ~2.4x smaller table and far fewer arrivals per
    # ray than the skip-chain formats.
    wide8_nodes: jnp.ndarray = _z(1, 48)      # (N8, 48) float32

    # 16-wide quantized stack format (accel.wide16 / ops.traverse_wide16)
    # — the production format: doubling node width and leaf count over
    # wide8 halves arrivals per ray.
    wide16_nodes: jnp.ndarray = _z(1, 96)     # (N16, 96) float32

    # Slot-indexed decode of the root's 16 children ((16, 119), see
    # accel.wide16.derive_top16) powering the gather-free traversal
    # prestep; (1, 119) placeholder disables level 2 statically.
    wide16_top: jnp.ndarray = _z(1, 119)

    # Level-3 slot table as 3 bf16 limbs ((3, 256, 119), see
    # accel.wide16.derive_top3_limbs): a bit-exact one-hot matmul
    # gather for prestep level 3; (3, 1, 119) placeholder disables it.
    wide16_top3: jnp.ndarray = _z(3, 1, 119)

    # Stack planes the wide8/wide16 register-stack traversal needs for THIS
    # scene: the SHAPE is the actual tree depth + margin (static), so the
    # (D, B) stack arrays and their per-arrival top-reads scale with the
    # real tree (~10-12 planes at 1M tris) instead of the format cap (24).
    stack_levels: jnp.ndarray = _z(24, dtype=jnp.int32)

    # Split-table variant (accel.wide2 / ops.traverse_wide2): hot internal
    # rows + cold shared leaf rows + per-octant leaf continuations.
    wide2_inner: jnp.ndarray = _z(1, 1, 32)   # (O, Ni, 32) float32
    wide2_leaf: jnp.ndarray = _z(1, 48)       # (Nl, 48) float32
    wide2_leaf_skip: jnp.ndarray = _z(1, 1, dtype=jnp.int32)  # (O, Nl)
    wide2_entry: jnp.ndarray = jnp.asarray(1, jnp.int32)      # root code

    # TLAS (Aila-Laine 2-wide) + instances.
    tlas_nodes: jnp.ndarray = _z(0, 16)       # (NT, 16) float32
    tlas_index: jnp.ndarray = _z(0, dtype=jnp.int32)
    inst_l2w: jnp.ndarray = _z(0, 12)         # (I, 12) row-major 3x4
    inst_w2l: jnp.ndarray = _z(0, 12)
    inst_offsets: jnp.ndarray = _z(0, 4, dtype=jnp.int32)

    @property
    def light_count(self) -> int:
        return int(self.lights.shape[0])


@dataclasses.dataclass
class Scene:
    """Host-side scene under construction."""

    meshes: list = dataclasses.field(default_factory=list)        # (Mesh, transform|None)
    materials: list = dataclasses.field(default_factory=list)     # MaterialDesc
    lights: list = dataclasses.field(default_factory=list)        # LightDesc
    textures: list = dataclasses.field(default_factory=list)      # np images
    env_image: np.ndarray | None = None
    # Instancing: (mesh_key, transform, material_index) for TLAS mode.
    instances: list = dataclasses.field(default_factory=list)
    # Per-mesh BLAS build cache (filled by _build_instanced).
    _blas_cache: tuple | None = dataclasses.field(default=None, repr=False)
    _blas8_cache: tuple | None = dataclasses.field(default=None, repr=False)
    _tlas8_layout: object | None = dataclasses.field(default=None, repr=False)
    _blas16_cache: tuple | None = dataclasses.field(default=None, repr=False)
    _tlas16_layout: object | None = dataclasses.field(default=None, repr=False)

    def set_instance_transform(self, instance_id: int, transform: np.ndarray) -> None:
        """Move an instance (``Bounce.cs`` analogue); next build() reuses
        cached BLASes and rebuilds only the TLAS."""
        mid, _old, mat = self.instances[instance_id]
        self.instances[instance_id] = (mid, np.asarray(transform, np.float32), mat)

    def add_material(self, desc: umaterial.MaterialDesc) -> int:
        self.materials.append(desc)
        return len(self.materials) - 1

    def add_texture(self, image: np.ndarray) -> int:
        self.textures.append(image)
        return len(self.textures) - 1

    def add_mesh(self, mesh: Mesh, transform: np.ndarray | None = None) -> int:
        self.meshes.append((mesh, transform))
        return len(self.meshes) - 1

    def add_instance(self, mesh_id: int, transform: np.ndarray,
                     material_index: int | None = None) -> int:
        self.instances.append((mesh_id, np.asarray(transform, np.float32), material_index))
        return len(self.instances) - 1

    def add_light(self, desc: ulights.LightDesc) -> int:
        self.lights.append(desc)
        return len(self.lights) - 1

    def set_environment(self, image: np.ndarray) -> None:
        self.env_image = np.asarray(image, np.float32)

    def world_bounds(self) -> tuple[np.ndarray, np.ndarray]:
        """World-space AABB over meshes and instances (for camera framing)."""
        los, his = [], []

        def acc(mesh, xf):
            v = mesh.vertices
            if xf is not None:
                v = v @ np.asarray(xf, np.float32)[:3, :3].T + xf[:3, 3]
            los.append(v.min(axis=0))
            his.append(v.max(axis=0))

        for mesh, xf in self.meshes:
            acc(mesh, xf)
        for mesh_id, xf, _mat in self.instances:
            acc(self.meshes[mesh_id][0], xf)
        if not los:
            return np.zeros(3, np.float32), np.ones(3, np.float32)
        return (np.min(los, axis=0).astype(np.float32),
                np.max(his, axis=0).astype(np.float32))

    # ------------------------------------------------------------------
    def flatten(self) -> FlatTriangles:
        """World-space flattened triangle soup (non-TLAS path)."""
        if not self.meshes:
            raise ValueError("scene has no meshes")
        parts = [flatten_mesh(mesh, transform) for mesh, transform in self.meshes]
        return concat_flat(parts)

    def build(self, traversal: str = "mbvh", octants: int = 1) -> SceneData:
        """Compile to device arrays; builds the acceleration structure.

        ``traversal``: "bruteforce" skips the BVH (empty node arrays);
        "bvh2"/"mbvh"/"skip"/"wide" run the host builders (accel package).
        ``octants``: per-ray-octant DFS orders for the wide format (1 or 8).
        Scenes with instances build the two-level (TLAS) wide structure and
        require ``traversal == "wide"``.
        """
        if self.instances:
            if traversal not in ("wide", "wide2", "wide8", "wide16"):
                raise ValueError(
                    "instanced scenes require traversal='wide', 'wide2', "
                    "'wide8' or 'wide16'")
            return self._build_instanced(traversal)
        flat = self.flatten()
        tris = flat.tri_records()
        m = flat.count
        tri_index = np.arange(m, dtype=np.int32)

        skip = np.zeros((1, 1, 8), np.float32)
        wide = np.zeros((1, 1, 48), np.float32)
        wide8 = np.zeros((1, 48), np.float32)
        wide16 = np.zeros((1, 96), np.float32)
        wide2 = None
        stack_depth = 24
        wide16_top = np.zeros((1, 119), np.float32)
        wide16_top3 = np.zeros((3, 1, 119), np.float32)
        if traversal == "wide16":
            from unity_webgpu_pathtracer_tpu.accel.wide16 import (
                build_scene_wide16,
                derive_top16,
                derive_top3_limbs,
            )

            w16 = build_scene_wide16(flat.positions, tris)
            wide16 = w16.nodes
            stack_depth = w16.depth + 1
            top = derive_top16(wide16)
            if top is not None:
                wide16_top = top
                top3 = derive_top3_limbs(wide16, top)
                if top3 is not None:
                    wide16_top3 = top3
            # Leaf rows index attributes by BVH-order position (same
            # permutation contract as wide8 below).  With the SBVH builder
            # `order` is a reference list (len >= tri count, duplicate ids
            # allowed): the fancy-indexed permutes below replicate rows for
            # duplicated refs, so every leaf lane still finds its record
            # and attributes at its own order position.
            order = w16.order
            tris = tris[order]
            flat = FlatTriangles(
                positions=flat.positions[order],
                normals=flat.normals[order],
                tangents=flat.tangents[order],
                uvs=flat.uvs[order],
                material=flat.material[order],
            )
            m = flat.count
            tri_index = np.arange(m, dtype=np.int32)
            bounds = np.zeros((1, 48), np.float32)
            child = np.zeros((1, 8), np.int32)
        elif traversal == "wide8":
            from unity_webgpu_pathtracer_tpu.accel.wide8 import build_scene_wide8

            w8 = build_scene_wide8(flat.positions, tris)
            wide8 = w8.nodes
            stack_depth = w8.depth + 1
            # Leaf rows index attributes by BVH-order position: permute the
            # triangle records and attribute arrays (spatially adjacent
            # leaves then read adjacent attr rows — gather locality).
            order = w8.order
            tris = tris[order]
            flat = FlatTriangles(
                positions=flat.positions[order],
                normals=flat.normals[order],
                tangents=flat.tangents[order],
                uvs=flat.uvs[order],
                material=flat.material[order],
            )
            bounds = np.zeros((1, 48), np.float32)
            child = np.zeros((1, 8), np.int32)
        elif traversal == "wide2":
            from unity_webgpu_pathtracer_tpu.accel import build_scene_wide_bvh
            from unity_webgpu_pathtracer_tpu.accel.wide2 import split_wide

            unified = build_scene_wide_bvh(flat.positions, tris, octants=octants)
            wide2 = split_wide(np.asarray(unified))
            bounds = np.zeros((1, 48), np.float32)
            child = np.zeros((1, 8), np.int32)
        elif traversal == "wide":
            from unity_webgpu_pathtracer_tpu.accel import build_scene_wide_bvh

            # Inline leaf storage: tris stay in original order (tri_index is
            # identity); leaf rows carry records + original attribute rows.
            wide = build_scene_wide_bvh(flat.positions, tris, octants=octants)
            bounds = np.zeros((1, 48), np.float32)
            child = np.zeros((1, 8), np.int32)
        elif traversal in ("bvh2", "mbvh"):
            from unity_webgpu_pathtracer_tpu.accel import build_scene_bvh

            bounds, child, order = build_scene_bvh(flat.positions)
            tris = tris[order]
            tri_index = tri_index[order].astype(np.int32)
        elif traversal == "skip":
            from unity_webgpu_pathtracer_tpu.accel import build_scene_skip_bvh

            skip, order = build_scene_skip_bvh(flat.positions)
            tris = tris[order]
            tri_index = tri_index[order].astype(np.int32)
            bounds = np.zeros((1, 48), np.float32)
            child = np.zeros((1, 8), np.int32)
        elif traversal == "bruteforce":
            bounds = np.zeros((1, 48), np.float32)
            child = np.zeros((1, 8), np.int32)
        else:
            raise ValueError(f"unknown traversal backend {traversal!r}")

        materials = umaterial.pack_materials(self.materials or [umaterial.MaterialDesc()])
        atlas = utexture.build_atlas(self.textures)
        light_table = (
            ulights.pack_lights(self.lights) if self.lights else np.zeros((0, 16), np.float32)
        )
        env = build_envmap(self.env_image) if self.env_image is not None else empty_envmap()

        extra = {}
        if wide2 is not None:
            ni = max(wide2.inner.shape[1], 1)
            inner = wide2.inner if wide2.inner.shape[1] else np.zeros(
                (wide2.inner.shape[0], 1, 32), np.float32)
            extra = dict(
                wide2_inner=jnp.asarray(inner),
                wide2_leaf=jnp.asarray(wide2.leaf_geo),
                wide2_leaf_skip=jnp.asarray(wide2.leaf_skip),
                wide2_entry=jnp.asarray(
                    1 if wide2.inner.shape[1] else -1, jnp.int32),
            )
        return SceneData(
            tris=jnp.asarray(tris),
            tri_index=jnp.asarray(tri_index),
            attr_normals=jnp.asarray(flat.normals.reshape(m, 9)),
            attr_tangents=jnp.asarray(flat.tangents.reshape(m, 9)),
            attr_uvs=jnp.asarray(flat.uvs.reshape(m, 6)),
            attr_material=jnp.asarray(flat.material),
            attr_shade=jnp.asarray(_pack_attr_shade(
                flat.normals.reshape(m, 9), flat.uvs.reshape(m, 6), flat.material)),
            attr_shade_c=jnp.asarray(_pack_or_placeholder(
                _pack_attr_shade_c, np.zeros((2, 8), np.uint32),
                flat.normals.reshape(m, 9), flat.uvs.reshape(m, 6),
                flat.material)),
            attr_shade_o=jnp.asarray(_pack_or_placeholder(
                _pack_attr_shade_o, np.zeros((4, 4), np.uint32),
                flat.normals.reshape(m, 9), flat.material)),
            materials=jnp.asarray(materials),
            texture_data=jnp.asarray(atlas),
            lights=jnp.asarray(light_table),
            env=env,
            bvh_bounds=jnp.asarray(bounds),
            bvh_child=jnp.asarray(child),
            skip_nodes=jnp.asarray(skip),
            wide_nodes=jnp.asarray(wide),
            wide8_nodes=jnp.asarray(wide8),
            wide16_nodes=jnp.asarray(wide16),
            wide16_top=jnp.asarray(wide16_top),
            wide16_top3=jnp.asarray(wide16_top3),
            stack_levels=jnp.zeros((stack_depth,), jnp.int32),
            **extra,
        )

    # ------------------------------------------------------------------
    def _build_instanced_wide8(self) -> SceneData:
        return self._build_instanced_quant("wide8")

    def _build_instanced_wide16(self) -> SceneData:
        return self._build_instanced_quant("wide16")

    def _build_instanced_quant(self, fmt: str) -> SceneData:
        """Two-level quantized build (wide8 or wide16): cached per-mesh
        BLASes + a TLAS over instances, one unified device table."""
        if fmt == "wide16":
            from unity_webgpu_pathtracer_tpu.accel.wide16 import (
                build_scene_wide16 as build_scene_quant,
                build_tlas_wide16 as build_tlas_quant,
            )
            cache_attr, layout_attr = "_blas16_cache", "_tlas16_layout"
        else:
            from unity_webgpu_pathtracer_tpu.accel.wide8 import (
                build_scene_wide8 as build_scene_quant,
                build_tlas_wide8 as build_tlas_quant,
            )
            cache_attr, layout_attr = "_blas8_cache", "_tlas8_layout"
        from unity_webgpu_pathtracer_tpu.scene import lights as ulights_mod

        if getattr(self, cache_attr, None) is None:
            blas, blas_bounds, parts, attr_bases = [], [], [], []
            attr_base = 0
            for mesh, _transform in self.meshes:
                flat = flatten_mesh(mesh, None)
                recs = flat.tri_records()
                w8 = build_scene_quant(flat.positions, recs)
                blas.append(w8)
                p = flat.positions.reshape(-1, 3)
                blas_bounds.append((p.min(0), p.max(0)))
                # Per-mesh BVH-order permutation (leaf idx are mesh-local
                # BVH positions + attr_base).  SBVH ref lists (wide16) may
                # be longer than the mesh's tri count; the permuted part
                # then carries one row per ref.
                o = w8.order
                parts.append(FlatTriangles(
                    positions=flat.positions[o], normals=flat.normals[o],
                    tangents=flat.tangents[o], uvs=flat.uvs[o],
                    material=flat.material[o]))
                attr_bases.append(attr_base)
                attr_base += int(o.shape[0])
            setattr(self, cache_attr, (blas, blas_bounds, parts, attr_bases))
        blas, blas_bounds, parts, attr_bases = getattr(self, cache_attr)

        flat_all = concat_flat(parts)
        m = flat_all.count
        instances = list(self.instances)
        w8, inst_l2w, inst_w2l, layout = build_tlas_quant(
            blas, blas_bounds, instances, attr_bases)
        setattr(self, layout_attr, layout)
        inst_offsets = np.zeros((len(instances), 4), np.int32)
        inst_offsets[:, 3] = [
            -1 if mat is None else mat for (_mid, _t, mat) in instances
        ]

        materials = umaterial.pack_materials(self.materials or [umaterial.MaterialDesc()])
        atlas = utexture.build_atlas(self.textures)
        light_table = (
            ulights_mod.pack_lights(self.lights) if self.lights else np.zeros((0, 16), np.float32)
        )
        env = build_envmap(self.env_image) if self.env_image is not None else empty_envmap()

        return SceneData(
            tris=jnp.asarray(flat_all.tri_records()),
            tri_index=jnp.arange(m, dtype=jnp.int32),
            attr_normals=jnp.asarray(flat_all.normals.reshape(m, 9)),
            attr_tangents=jnp.asarray(flat_all.tangents.reshape(m, 9)),
            attr_uvs=jnp.asarray(flat_all.uvs.reshape(m, 6)),
            attr_material=jnp.asarray(flat_all.material),
            attr_shade=jnp.asarray(_pack_attr_shade(
                flat_all.normals.reshape(m, 9), flat_all.uvs.reshape(m, 6),
                flat_all.material)),
            attr_shade_c=jnp.asarray(_pack_or_placeholder(
                _pack_attr_shade_c, np.zeros((2, 8), np.uint32),
                flat_all.normals.reshape(m, 9), flat_all.uvs.reshape(m, 6),
                flat_all.material)),
            attr_shade_o=jnp.asarray(_pack_or_placeholder(
                _pack_attr_shade_o, np.zeros((4, 4), np.uint32),
                flat_all.normals.reshape(m, 9), flat_all.material)),
            materials=jnp.asarray(materials),
            texture_data=jnp.asarray(atlas),
            lights=jnp.asarray(light_table),
            env=env,
            inst_l2w=jnp.asarray(inst_l2w),
            inst_w2l=jnp.asarray(inst_w2l),
            inst_offsets=jnp.asarray(inst_offsets),
            # +4 margin (vs +1 static): TLAS-only transform updates re-emit
            # TLAS rows in place, and the rebuilt tree may deepen slightly
            # without changing this static shape.
            stack_levels=jnp.zeros((w8.depth + 4,), jnp.int32),
            **{("wide16_nodes" if fmt == "wide16" else "wide8_nodes"):
               jnp.asarray(w8.nodes)},
        )

    # ------------------------------------------------------------------
    def _build_instanced(self, traversal: str = "wide") -> SceneData:
        """Two-level build: per-mesh wide BLASes + TLAS over instances
        (the analogue of ``BVHScene.cs:601-757``).  Attributes stay in mesh
        local space; instance transforms are applied at hit-shading time."""
        from unity_webgpu_pathtracer_tpu.accel import build_scene_wide_bvh
        from unity_webgpu_pathtracer_tpu.accel.tlas import build_tlas_wide
        from unity_webgpu_pathtracer_tpu.scene import lights as ulights_mod

        if traversal == "wide8":
            return self._build_instanced_wide8()
        # BLAS tables are cached on the Scene so transform-only updates
        # (the reference's per-frame TLAS rebuild path, BVHScene.cs:769-841)
        # rebuild just the small top level.
        if getattr(self, "_blas_cache", None) is None:
            blas_tables, blas_bounds, parts = [], [], []
            attr_base = 0
            for mesh, _transform in self.meshes:
                flat = flatten_mesh(mesh, None)
                recs = flat.tri_records()
                table = np.array(build_scene_wide_bvh(flat.positions, recs, octants=1))
                # Re-base the inline leaf attribute indices to the global tables.
                kinds = table[0, :, 44:46].view(np.int32)[:, 1]
                idx = table[0, :, 36:40].view(np.int32)
                idx[kinds > 0] += attr_base
                table[0, :, 36:40] = idx.view(np.float32)
                blas_tables.append(table)
                blas_bounds.append(
                    (flat.positions.reshape(-1, 3).min(0),
                     flat.positions.reshape(-1, 3).max(0))
                )
                parts.append(flat)
                attr_base += flat.count
            self._blas_cache = (blas_tables, blas_bounds, parts)
        blas_tables, blas_bounds, parts = self._blas_cache

        flat_all = concat_flat(parts)
        tris = flat_all.tri_records()
        m = flat_all.count

        instances = [(mid, t, mat) for (mid, t, mat) in self.instances]
        tl = build_tlas_wide(blas_tables, blas_bounds, instances)
        inst_offsets = np.zeros((len(instances), 4), np.int32)
        inst_offsets[:, 3] = tl.inst_material

        materials = umaterial.pack_materials(self.materials or [umaterial.MaterialDesc()])
        atlas = utexture.build_atlas(self.textures)
        light_table = (
            ulights_mod.pack_lights(self.lights) if self.lights else np.zeros((0, 16), np.float32)
        )
        env = build_envmap(self.env_image) if self.env_image is not None else empty_envmap()

        extra = {}
        if traversal == "wide2":
            from unity_webgpu_pathtracer_tpu.accel.wide2 import split_wide

            w2 = split_wide(np.asarray(tl.nodes))
            inner = w2.inner if w2.inner.shape[1] else np.zeros(
                (w2.inner.shape[0], 1, 32), np.float32)
            extra = dict(
                wide2_inner=jnp.asarray(inner),
                wide2_leaf=jnp.asarray(w2.leaf_geo),
                wide2_leaf_skip=jnp.asarray(w2.leaf_skip),
                wide2_entry=jnp.asarray(1 if w2.inner.shape[1] else -1, jnp.int32),
            )
        return SceneData(
            tris=jnp.asarray(tris),
            tri_index=jnp.arange(m, dtype=jnp.int32),
            attr_normals=jnp.asarray(flat_all.normals.reshape(m, 9)),
            attr_tangents=jnp.asarray(flat_all.tangents.reshape(m, 9)),
            attr_uvs=jnp.asarray(flat_all.uvs.reshape(m, 6)),
            attr_material=jnp.asarray(flat_all.material),
            attr_shade=jnp.asarray(_pack_attr_shade(
                flat_all.normals.reshape(m, 9), flat_all.uvs.reshape(m, 6),
                flat_all.material)),
            attr_shade_c=jnp.asarray(_pack_or_placeholder(
                _pack_attr_shade_c, np.zeros((2, 8), np.uint32),
                flat_all.normals.reshape(m, 9), flat_all.uvs.reshape(m, 6),
                flat_all.material)),
            attr_shade_o=jnp.asarray(_pack_or_placeholder(
                _pack_attr_shade_o, np.zeros((4, 4), np.uint32),
                flat_all.normals.reshape(m, 9), flat_all.material)),
            materials=jnp.asarray(materials),
            texture_data=jnp.asarray(atlas),
            lights=jnp.asarray(light_table),
            env=env,
            wide_nodes=jnp.asarray(tl.nodes),
            inst_l2w=jnp.asarray(tl.inst_l2w),
            inst_w2l=jnp.asarray(tl.inst_w2l),
            inst_offsets=jnp.asarray(inst_offsets),
            **extra,
        )


def rebuild_tlas_rows(scene: "Scene", fmt: str = "wide8"):
    """Transform-only TLAS refresh for wide8/wide16 scenes: re-emits ONLY
    the fixed-capacity TLAS section (cost independent of BLAS size — the
    reference's per-frame path, ``BVHScene.cs:769-841``).

    Returns ``(tlas_rows (cap,R), inst_l2w, inst_w2l)``; apply with
    ``scene_data._replace(<fmt>_nodes=<fmt>_nodes.at[:cap].set(rows), ...)``.
    """
    if fmt == "wide16":
        from unity_webgpu_pathtracer_tpu.accel.wide16 import (
            emit_tlas_rows16 as emit_rows,
        )
        cache, layout = scene._blas16_cache, scene._tlas16_layout
    else:
        from unity_webgpu_pathtracer_tpu.accel.wide8 import (
            emit_tlas_rows as emit_rows,
        )
        cache, layout = scene._blas8_cache, scene._tlas8_layout
    if cache is None or layout is None:
        raise ValueError(
            f"no cached {fmt} two-level build; build({fmt!r}) first")
    _blas, blas_bounds, _parts, _attr_bases = cache
    kw = {}
    if fmt == "wide16":
        # Match the built table's row width (96 classic / 48 leaf8).
        kw["row_f"] = int(_blas[0].nodes.shape[1])
    rows, tdepth, l2w, w2l = emit_rows(
        list(scene.instances), blas_bounds, layout.blas_root,
        layout.tlas_cap, **kw)
    # The device stack was sized at build time (build depth + 4 planes of
    # margin); a transform change must not deepen the TLAS past it.
    if tdepth > layout.tlas_depth0 + 3:
        raise ValueError(
            f"TLAS deepened past the allocated traversal stack "
            f"(depth {tdepth} > {layout.tlas_depth0} + 3 margin); "
            f"rebuild the scene")
    return rows, l2w, w2l
