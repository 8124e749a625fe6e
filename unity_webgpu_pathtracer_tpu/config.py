"""Render configuration.

The reference splits configuration in two tiers (SURVEY.md §5): serialized
MonoBehaviour fields (``Assets/Scripts/PathTracer.cs:24-50``) and shader
``multi_compile`` keyword variants (``PathTracer.compute:6-9``).  Here the
same split maps onto JAX's compilation model:

* :class:`RenderConfig` — frozen, hashable dataclass passed as a *static*
  ``jit`` argument.  Changing any field triggers a recompile, exactly like
  switching a shader variant (HAS_TLAS / HAS_TEXTURES / HAS_ENVIRONMENT_TEXTURE
  / HAS_LIGHTS become booleans here).
* :class:`RenderParams` — a pytree of traced uniforms (camera matrices, env
  intensity, seeds, ...), mirroring the per-frame ``SetVector``/``SetFloat``
  uniform uploads (``PathTracer.cs:230-249``).  Changing these never
  recompiles.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

# Sky modes (common.hlsl:85-86)
SKY_MODE_ENVIRONMENT = 0
SKY_MODE_BASIC = 1

# Tonemap modes (Presentation.shader:42-56)
TONEMAP_NONE = 0
TONEMAP_ACES = 1
TONEMAP_FILMIC = 2
TONEMAP_REINHARD = 3
TONEMAP_LOTTES = 4

# Alpha modes (common.hlsl:88-90)
ALPHA_MODE_OPAQUE = 0
ALPHA_MODE_BLEND = 1
ALPHA_MODE_MASK = 2

# Light types (common.hlsl:137-145)
LIGHT_TYPE_SPOT = 0
LIGHT_TYPE_DIRECTIONAL = 1
LIGHT_TYPE_POINT = 2
LIGHT_TYPE_RECTANGLE = 3


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static (compile-time) render configuration.

    Defaults follow the reference MonoBehaviour defaults
    (``PathTracer.cs:24-50``): samplesPerPass=1, maxRayBounces=5, RR on,
    firefly filter off.
    """

    width: int = 512
    height: int = 512
    samples_per_pass: int = 1
    max_bounces: int = 5
    use_russian_roulette: bool = True
    use_firefly_filter: bool = False
    # Paint samples whose BSDF sample went NaN pure green instead of
    # dropping them silently (the reference's canary,
    # pathtrace.hlsl:100-104: ``radiance = float3(0,1,0); break``).
    debug_nan_canary: bool = False
    sky_mode: int = SKY_MODE_BASIC

    # Feature flags = shader multi_compile variants (PathTracer.compute:6-9).
    has_environment_texture: bool = False
    has_lights: bool = False
    has_textures: bool = False
    has_tlas: bool = False
    # Live normal mapping (the reference ships this disabled,
    # util/material.hlsl:114-133): tangents are gathered and the shading
    # normal perturbed only when this static flag is on — scenes without
    # normal maps pay nothing.
    has_normal_maps: bool = False

    # Thin-lens DoF active (camera.hlsl:22). Static so the pinhole path
    # compiles without the lens sampling code, like Aperture==0 in-kernel.
    use_depth_of_field: bool = False

    # Traversal backend: "bruteforce" | "bvh2" | "mbvh" | "skip" | "wide"
    # | "wide2" | "wide8" | "wide16".
    # Supported tiers: "wide16" is PRODUCTION, "wide8" the mid-tier
    # cross-check, "bruteforce" the oracle (megakernel integrator).  The
    # rest (skip/mbvh/wide/wide2) are FROZEN experiment backends — kept
    # importable and correct for A/B comparison, not performance-maintained.
    traversal: str = "mbvh"

    # Octant-specialized DFS orders for the wide format (1 or 8): 8 orders
    # visit near-first (fewer arrivals) but 8x the node table.
    bvh_octants: int = 1

    # Integrator: "megakernel" (lax.scan bounce loop, correctness
    # reference), "wavefront" (staged ray pool + regeneration) or "fused"
    # (render/fused.py, the production path).
    integrator: str = "megakernel"

    # Wavefront pool size (rays resident per step); 0 = auto
    # (min(width*height*spp, 96k)).
    pool_size: int = 0

    # Fused integrator: arrivals per transition step (occupancy/cost knob —
    # each transition costs ~3 gather ops, each arrival 1; lanes that finish
    # a traversal segment idle until the next transition).
    transition_every: int = 4

    # Chunked lane film (fused integrator): the shared work queue hands
    # out chunks of consecutive samples of one pixel; radiance accumulates
    # in-lane, completed chunks park in one flush slot per lane, and an
    # outer loop scatters all slots every chunk-size super-iterations —
    # the film scatter runs chunk-size times less often.  False = legacy
    # per-transition scatter-add film.  Off by default; films are
    # bit-identical either way.
    use_lane_film: bool = False

    # Sorted-prefix film (fused integrator): the legacy film issues one
    # scatter slot per lane per transition, most of them out-of-bounds
    # drops.  This mode rank-gates dying lanes to at most
    # K = pool >> film_k_shift accepted records per transition, compacts
    # them to a K-prefix with ONE lax.sort and scatters only K slots.
    # Rejected lanes keep their radiance in-lane (mode stays DEAD, no
    # regeneration) and retry next transition — backpressure instead of
    # record loss, so correctness is unconditional; a post-loop flush
    # catches stragglers.  Per-sample radiance is bit-identical to the
    # legacy film; only scatter-add association differs (<= 1 ulp).
    use_sorted_film: bool = True

    # K = pool_size >> film_k_shift accepted film records per transition
    # (sorted and record films).  With the record film (the production
    # default) shift 0 (K = B) statically removes the rank-gate cumsum and
    # never applies backpressure.  The sorted SCATTER film prices per
    # slot, so a shift of 1 (K = B/2) suits it; larger shifts throttle on
    # synchronized death bursts.
    film_k_shift: int = 0

    # Sorted/record films: sort (key, lane-index) and GATHER the K-prefix
    # radiance rows through the permutation instead of sorting the three
    # radiance channels as sort payloads.
    film_sort_perm: bool = False

    # Record film (fused integrator): removes the film scatter from the
    # hot loop ENTIRELY.  Death records are rank-gated and sort-compacted
    # exactly like the sorted-prefix film, but the K-prefix is APPENDED to
    # a pass-lifetime (budget + pool) record buffer with one
    # ``lax.dynamic_update_slice`` (a contiguous in-place write — the
    # while carry aliases, no scatter slots at all) at a moving cursor;
    # garbage tail rows are overwritten by the next append.  Each (pixel,
    # sample) work item dies exactly once, so the pass produces exactly
    # npix*spp valid records; ONE end-of-pass global sort groups them by
    # pixel into a dense (npix, spp, 3) block that a plain reshape-sum
    # resolves — no scatter there either.  Takes precedence over
    # use_sorted_film.  Film association differs from the legacy scatter
    # by sum order only (resolve sums each pixel's spp records in sorted
    # order); per-sample radiance is bit-identical.  The record buffer
    # holds 16 bytes per sample of the pass (key + rgb).
    use_record_film: bool = True

    # Gather-free first-arrival prestep for fresh ray segments (wide16):
    # the root level (and, for non-instanced scenes, the second level) is
    # descended from broadcast constants / a slot select chain instead of
    # row gathers (ops.traverse_wide16.prestep16).
    use_prestep: bool = True

    # Transition attribute fetch layout: False = gather the packed
    # (ceil(T/3), 48) attr_shade row and select this tri's 16 floats;
    # True = reshape the same table to (3*ceil(T/3), 16) and gather the
    # triangle's row directly (no select, 1/3 the gathered bytes).  Films
    # bit-identical either way.
    attr_direct: bool = True

    # Compact transition attribute rows: gather the 32-byte f16 table
    # (scene.attr_shade_c) instead of the 64-byte f32 rows and decode
    # in-register, halving the table footprint.  Precision: f16 normals
    # (~1e-3 on unit vectors) and uvs (~5e-4, <=1 texel at 2k).  Modes:
    # 0/False = off, 1/True = one tri per 32-byte row, 2 = two tris per
    # 64-byte row (same footprint, one extra select).  Per-pixel film
    # delta vs f32 attrs is ~2e-5 rel on small scenes, within MC noise at
    # production spp.
    # Mode 3 = 16-byte rows (3 octahedral-u32 vertex normals + material,
    # FOUR tris per gathered 64-byte row, scene._pack_attr_shade_o):
    # quarter the mode-2 footprint, but stores NO uv — statically
    # requires has_textures=False and has_normal_maps=False (the fused
    # integrator raises otherwise).
    attr_compact: int = 2

    # Iterate the te arrivals with ONE lax.fori_loop instead of a Python
    # unroll: the traversal section of the while-body HLO shrinks ~te-x
    # (a compile-time lever); the per-lane arithmetic is identical.
    arrival_fori: bool = False

    # Thread the (M, 16) paired attr table through the while-loop carry
    # instead of closing over the jit parameter, so XLA may choose the
    # table's gather layout once at loop entry.  ONLY applies with
    # ``attr_compact`` 2 or 3 (the paired/quad-row layouts); under other
    # attr layouts the flag is silently a no-op.
    attr_carry: bool = True

    # Same carry-threading for the wide16 node table and the merged env
    # rows.  node_carry applies to wide16 only; env_carry to merged-row
    # env maps only (no-ops otherwise).
    node_carry: bool = False
    env_carry: bool = False

    # Clamp the transition's gather indices (attr rows, merged env rows) to
    # row 0 for lanes that cannot consume the gathered value this
    # transition: lanes mid-shadow-traversal, dead lanes awaiting regen,
    # and (for the env rows) lanes that did not just finish a primary
    # segment.  The gather still issues for all B lanes (static shapes),
    # but the stale lanes' issues hit one cache-hot row instead of a cold
    # random one.  Films are bit-identical by construction: every consumer
    # of the gathered rows is already masked by shade/env_done/light_done
    # (tests/test_features.py::test_mask_stale_gathers_film_identical,
    # tests/test_features.py::test_mask_stale_gathers_identical_with_lights).
    mask_stale_gathers: bool = True

    # Extract the merged-env-row fields from the TRANSPOSED gather result
    # (contiguous (B,) slices) instead of strided [B, j] columns.
    # Per-element values and op order are identical -> films bit-identical
    # (tests/test_features.py::test_env_split_rows_film_identical).
    env_split_rows: bool = False

    # Prestep depth: 2 = root + child-slot select chain; 3 adds a THIRD
    # gather-free level via a bit-exact 3-limb bf16 one-hot matmul over
    # the 256 grandchild slots (accel.wide16.derive_top3_limbs).
    prestep_levels: int = 2

    dtype: Any = jnp.float32

    def pixel_count(self) -> int:
        return self.width * self.height


def _f32(x):
    return jnp.asarray(x, dtype=jnp.float32)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class RenderParams:
    """Traced per-frame uniforms (the reference's cbuffer uniforms).

    ``cam_to_world`` / ``cam_inv_proj`` mirror ``CamToWorld``/``CamInvProj``
    (camera.hlsl:7-8); environment fields mirror ``PathTracer.cs:230-249``.
    """

    cam_to_world: jnp.ndarray          # (4,4)
    cam_inv_proj: jnp.ndarray          # (4,4)
    aperture: jnp.ndarray = dataclasses.field(default_factory=lambda: _f32(0.0))
    focal_length: jnp.ndarray = dataclasses.field(default_factory=lambda: _f32(0.0))
    environment_intensity: jnp.ndarray = dataclasses.field(default_factory=lambda: _f32(1.0))
    environment_rotation: jnp.ndarray = dataclasses.field(default_factory=lambda: _f32(0.0))
    environment_color: jnp.ndarray = dataclasses.field(
        default_factory=lambda: _f32(np.array([0.5, 0.5, 0.5]))
    )
    max_firefly_luminance: jnp.ndarray = dataclasses.field(default_factory=lambda: _f32(100.0))
    seed_root: jnp.ndarray = dataclasses.field(
        default_factory=lambda: jnp.asarray(0, dtype=jnp.uint32)
    )

    def tree_flatten(self):
        fields = dataclasses.fields(self)
        return tuple(getattr(self, f.name) for f in fields), tuple(f.name for f in fields)

    @classmethod
    def tree_unflatten(cls, names, values):
        return cls(**dict(zip(names, values)))


@dataclasses.dataclass(frozen=True)
class PostParams:
    """Presentation blit parameters (``Presentation.shader:19-27``).

    Python-level (host) config: the post chain is cheap and re-jits per
    tonemap mode like the reference's shader variants.
    """

    mode: int = TONEMAP_ACES
    srgb: bool = True
    exposure: float = 1.0
    brightness: float = 1.0
    contrast: float = 1.0
    saturation: float = 1.0
    vignette: float = 0.0
