"""Fused traversal+shade wavefront — the production integrator.

The barrier-free endgame of the wavefront design (see render/wavefront.py
for the staged variant and SURVEY.md §2.4/§5): ONE ``lax.while_loop`` whose
iteration interleaves

* ``TRANSITION_EVERY`` × one traversal arrival
  (:func:`ops.traverse_wide16.arrival_step16` in production) — every lane
  advances its own traversal (primary closest-hit or NEE shadow any-hit) by
  one fat-row gather; finished lanes idle at most a few steps;
* one *transition* step — lanes whose traversal just finished move through
  the per-bounce state machine: primary-hit shading (material fetch, sky
  MIS, emission, alpha passthrough), environment NEE setup, analytic-light
  NEE setup, shadow-result application, BSDF sampling + Russian roulette,
  film splat on path death, and immediate path regeneration from the pass's
  (pixel, sample) work queue.

There is no synchronization point anywhere between path starts: mean path
cost, not worst-case, governs throughput — the property the per-bounce
barrier integrators lack.

Film accumulation: the record film (default) appends death records and
resolves them with one sort at the end of the pass; the sorted-prefix
and legacy films scatter-add died lanes' radiance every transition, with
DISTINCT out-of-bounds indices for surviving lanes (a shared OOB sentinel
is a mass duplicate a scatter may serialize before dropping).  The
optional chunked lane film (``config.use_lane_film``) hands out chunks
of ``ch`` consecutive samples of one pixel, accumulates in-lane and
flushes one slot per lane per iteration (fewer real scatter indices, a
coarser queue).  Per-sample radiance is bit-identical between all film
modes (same (pixel, sample) seeds); only the summation order differs.

State machine modes::

    PRIMARY ──hit──> (shade) ──env NEE──> SHADOW_ENV ──> (apply, light NEE)
      │                │ basic sky: straight to BSDF        │
      │ miss           └────────────────────────┐           v
      v                                         ├──> SHADOW_LIGHT ──> (apply)
    sky+MIS -> DEAD -> regen -> PRIMARY         └──────> BSDF sample + RR
                                                          │
                                             PRIMARY (next bounce) or DEAD

Radiometry matches the megakernel integrator (same stage functions) within
Monte-Carlo noise; RNG pairing differs (documented wavefront deviation).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from unity_webgpu_pathtracer_tpu.config import (
    ALPHA_MODE_BLEND,
    ALPHA_MODE_MASK,
    LIGHT_TYPE_POINT,
    LIGHT_TYPE_RECTANGLE,
    LIGHT_TYPE_SPOT,
    SKY_MODE_ENVIRONMENT,
    RenderConfig,
    RenderParams,
)
from unity_webgpu_pathtracer_tpu.ops.traverse_wide import (
    WideState,
    arrival_step,
    octant_index,
)
from unity_webgpu_pathtracer_tpu.render import bsdf as ubsdf
from unity_webgpu_pathtracer_tpu.render import camera as ucamera
from unity_webgpu_pathtracer_tpu.render import film as ufilm
from unity_webgpu_pathtracer_tpu.render.lights import (
    _unity_falloff,
    spot_cone_fade,
)
from unity_webgpu_pathtracer_tpu.render.sampling import power_heuristic, uniform_sample_sphere
from unity_webgpu_pathtracer_tpu.render.sky import sample_sky_radiance
from unity_webgpu_pathtracer_tpu.scene.envmap import sample_env_transition
from unity_webgpu_pathtracer_tpu.scene.material import derive_material
from unity_webgpu_pathtracer_tpu.utils import rng as urng
from unity_webgpu_pathtracer_tpu.utils.math import (
    EPSILON,
    FAR_PLANE,
    PI,
    cross,
    dot,
    dot1,
    gather_small,
    length,
    luminance,
    normalize,
    safe_rcp,
)

MODE_PRIMARY = 0
MODE_SHADOW_ENV = 1
MODE_SHADOW_LIGHT = 2
MODE_DEAD = 3

TRANSITION_EVERY = 4  # default; RenderConfig.transition_every overrides


def _chunk_size(config: RenderConfig, spp_l: int) -> int:
    """Samples per work-queue chunk for the lane film: the largest divisor
    of the shard's samples-per-pass <= 8.  The film scatter amortizes by
    this factor; larger chunks coarsen queue balancing."""
    for c in (8, 4, 2, 1):
        if spp_l % c == 0:
            return c
    return 1


class FusedState(NamedTuple):
    mode: jnp.ndarray          # (B,) int32
    trav: WideState            # active traversal registers
    trav_o: jnp.ndarray        # (B,3) active ray origin
    trav_d: jnp.ndarray        # (B,3) active ray direction

    # Primary-path registers (survive across shadow traversals).
    path_o: jnp.ndarray        # (B,3)
    path_d: jnp.ndarray        # (B,3)
    hit_t: jnp.ndarray         # (B,)
    hit_uv_bary: jnp.ndarray   # (B,2)
    hit_tri: jnp.ndarray       # (B,) int32 attribute row (-1 = miss)
    hit_inst: jnp.ndarray      # (B,) int32 instance of the hit (-1 = none)

    pending: jnp.ndarray       # (B,3) NEE contribution awaiting shadow result
    throughput: jnp.ndarray    # (B,3)
    radiance: jnp.ndarray      # (B,3)
    rng: jnp.ndarray           # (B,) uint32
    pixel: jnp.ndarray         # (B,) int32
    depth: jnp.ndarray         # (B,) int32
    max_roughness: jnp.ndarray # (B,)
    prev_pdf: jnp.ndarray      # (B,)
    lane_cap: jnp.ndarray      # (B,) int32 transition budget (alpha guard)

    film: jnp.ndarray          # (npix,3) [legacy scatter film; (1,3) dummy]
    queue_head: jnp.ndarray    # () samples started (legacy: queue cursor)
    arrivals: jnp.ndarray      # () uint32 (1080p x 32 spp ~ 1.7e9 > int32/2)
    rays: jnp.ndarray          # () closest+shadow rays started
    busy: jnp.ndarray          # () lanes busy ticks
    ticks: jnp.ndarray         # ()

    # Chunked lane film (config.use_lane_film): the queue hands out chunks
    # of `ch` consecutive samples of one pixel; radiance accumulates
    # in-lane and completed chunks sit in one flush slot per lane until
    # the outer loop's periodic scatter.
    accum: jnp.ndarray = jnp.zeros((1, 3))   # (B,3) current chunk radiance
    samp_i: jnp.ndarray = jnp.zeros(1, jnp.int32)      # (B,) index in chunk
    samp_i_base: jnp.ndarray = jnp.zeros(1, jnp.int32)  # (B,) chunk sample base
    flush_pix: jnp.ndarray = jnp.zeros(1, jnp.int32)   # (B,) slot pixel (npix = empty)
    flush_rgb: jnp.ndarray = jnp.zeros((1, 3))         # (B,3) slot radiance

    # Sorted-prefix film (config.use_sorted_film): dead lanes whose death
    # record was rank-rejected this transition (over the K budget); they
    # hold their radiance and retry before taking new work.
    rec_pending: jnp.ndarray = jnp.zeros(1, bool)      # (B,)

    # Record film (config.use_record_film): pass-lifetime death-record
    # buffer (budget + pool rows) + append cursor.  Valid rows carry
    # (pixel, rgb); never-written / garbage-tail rows carry key >= npix
    # and sort to the back of the end-of-pass resolve.  The rgb channels
    # are stored as three 1-D arrays, which are the sort's payload
    # operands as they stand.
    rec_keys: jnp.ndarray = jnp.zeros(1, jnp.int32)    # (C,)
    rec_v0: jnp.ndarray = jnp.zeros(1)                 # (C,)
    rec_v1: jnp.ndarray = jnp.zeros(1)                 # (C,)
    rec_v2: jnp.ndarray = jnp.zeros(1)                 # (C,)
    rec_cursor: jnp.ndarray = jnp.zeros((), jnp.int32)  # () rows appended


def _set_trav(s: FusedState, mask, o, d, t_max, entry=None):
    """Point lanes' traversal at a fresh ray (world space, regs reset).

    ``entry`` is the root position code: 0 for the unified wide format
    (row index space), ``scene.wide2_entry`` for the split format (signed
    code space, where a ``pending`` register also needs clearing).

    Backend-specific registers are reset by duck-typing on the state's
    NamedTuple fields (``pending`` = wide2's parked leaf; ``pend``/``sp``
    = the register-mask stacks, FULL mask 0xFFFF for wide16's
    ``stack_mask`` layout vs 0xFF for wide8) — no per-backend type chain.
    """
    m3 = mask[:, None]
    tr = s.trav
    root = 0 if entry is None else entry
    trav = tr._replace(
        ptr=jnp.where(mask, root, tr.ptr),
        t=jnp.where(mask, t_max, tr.t),
        u=jnp.where(mask, 0.0, tr.u),
        v=jnp.where(mask, 0.0, tr.v),
        tri=jnp.where(mask, -1, tr.tri),
        found=jnp.where(mask, False, tr.found),
        inst=jnp.where(mask, -1, tr.inst),
        hit_inst=jnp.where(mask, -1, tr.hit_inst),
    )
    fields = tr._fields
    extra = {}
    if "pending" in fields:
        extra["pending"] = jnp.where(mask, 0, tr.pending)
    if "pend" in fields:
        full = 0xFFFF if "stack_mask" in fields else 0xFF
        extra["pend"] = jnp.where(mask, full, tr.pend)
        extra["sp"] = jnp.where(mask, 0, tr.sp)
    if extra:
        trav = trav._replace(**extra)
    return s._replace(
        trav=trav,
        trav_o=jnp.where(m3, o, s.trav_o),
        trav_d=jnp.where(m3, d, s.trav_d),
    )


def _oct_decode(u):
    """16-bit-octahedral u32 -> unnormalized vec3 (scene._oct_encode_u32
    inverse), the attr_compact=3 normal fetch."""
    x = (u & jnp.uint32(0xFFFF)).astype(jnp.float32) \
        * jnp.float32(2.0 / 65535.0) - 1.0
    y = (u >> jnp.uint32(16)).astype(jnp.float32) \
        * jnp.float32(2.0 / 65535.0) - 1.0
    z = 1.0 - jnp.abs(x) - jnp.abs(y)
    t_f = jnp.maximum(-z, 0.0)
    x = x - jnp.where(x >= 0, t_f, -t_f)
    y = y - jnp.where(y >= 0, t_f, -t_f)
    return jnp.stack([x, y, z], axis=-1)


def _interp(bary, attr, width):
    a0 = attr[:, 0 * width : 1 * width]
    a1 = attr[:, 1 * width : 2 * width]
    a2 = attr[:, 2 * width : 3 * width]
    w0 = (1.0 - bary[:, 0] - bary[:, 1])[:, None]
    return a0 * w0 + a1 * bary[:, 0:1] + a2 * bary[:, 1:2]


def _light_hit_step(rec, i, o, d, t_best, idx):
    """One rect light tested against all lanes (``intersect.hlsl:29-54``)."""
    is_rect = rec[3] == 3.0
    pos, u, v = rec[0:3], rec[8:11], rec[12:15]
    n = normalize(cross(u, v))
    dt = dot(d, jnp.broadcast_to(n, d.shape))
    tt = (jnp.sum(n * pos) - dot(o, jnp.broadcast_to(n, o.shape))) / jnp.where(dt == 0, 1e-20, dt)
    p = o + d * tt[:, None]
    vi = p - pos
    a1 = dot(jnp.broadcast_to(u / jnp.maximum(jnp.sum(u * u), 1e-20), p.shape), vi)
    a2 = dot(jnp.broadcast_to(v / jnp.maximum(jnp.sum(v * v), 1e-20), p.shape), vi)
    hit = (
        is_rect & (tt > EPSILON) & (tt < t_best)
        & (a1 >= 0) & (a1 <= 1) & (a2 >= 0) & (a2 <= 1) & (dt < 0)
    )
    return jnp.where(hit, tt, t_best), jnp.where(hit, i, idx)


def _analytic_light_hit(scene, o, d, t):
    """Closest rect-light hit below t; returns (hit_mask, t_light,
    light_index).  Small light tables unroll (lets XLA fuse across
    lights); larger ones run an on-device ``fori_loop`` so compile size
    and code bloat stay FLAT in light count (the reference loops on-GPU,
    ``util/intersect.hlsl:31``) while memory stays (B,)-shaped.
    """
    t_best = t
    idx = jnp.full(t.shape, -1, jnp.int32)
    lcount = scene.lights.shape[0]
    if lcount <= 4:
        for i in range(lcount):
            t_best, idx = _light_hit_step(scene.lights[i], i, o, d, t_best, idx)
    else:
        def body(i, carry):
            t_b, ix = carry
            return _light_hit_step(scene.lights[i], i, o, d, t_b, ix)

        t_best, idx = jax.lax.fori_loop(0, lcount, body, (t_best, idx))
    return idx >= 0, t_best, idx


def _transition(scene, config: RenderConfig, params: RenderParams,
                s: FusedState, budget: int, current_sample, trav_done,
                entry=None, shard=None, attr_pair=None):
    b = s.mode.shape[0]
    env_nee = config.sky_mode == SKY_MODE_ENVIRONMENT
    light_nee = config.has_lights and scene.lights.shape[0] > 0
    if shard is None:
        shard = (jnp.uint32(0), config.pixel_count(), jnp.uint32(0))

    shadow_done = trav_done | s.trav.found
    rng_state = s.rng

    # =====================================================================
    # Stage A: primary traversal finished -> shade / NEE setup / BSDF.
    # =====================================================================
    a = (s.mode == MODE_PRIMARY) & trav_done

    hit_valid = s.trav.tri >= 0
    t_hit = s.trav.t
    bary = jnp.stack([s.trav.u, s.trav.v], axis=-1)

    # Analytic light interception (may be closer than the triangle hit).
    if light_nee:
        lhit, t_light, lidx = _analytic_light_hit(scene, s.path_o, s.path_d, t_hit)
    else:
        lhit = jnp.zeros((b,), bool)
        lidx = jnp.zeros((b,), jnp.int32)

    # --- miss -> sky with MIS (and, for HDRI scenes, the env-NEE sample:
    # miss lanes and NEE lanes are disjoint, so ONE gather serves both,
    # scene.envmap.sample_env_transition) ---
    env_merged = env_nee and config.has_environment_texture
    mask_stale = bool(getattr(config, "mask_stale_gathers", False))
    if env_merged:
        want_alias = a & hit_valid
        (sky_raw, sky_pdf, env_dir, env_col, env_pdf,
         rng_state) = sample_env_transition(
            scene.env, params.environment_rotation, s.path_d, want_alias,
            rng_state, need=a if mask_stale else None,
            split=bool(getattr(config, "env_split_rows", False)))
        intensity = jnp.where(s.depth > 0, params.environment_intensity, 1.0)
        sky_color = sky_raw * intensity[:, None]
        env_li = env_col * params.environment_intensity
    else:
        sky_color, sky_pdf = sample_sky_radiance(config, params, scene.env,
                                                 s.path_d, s.depth)
    mis = jnp.where(s.depth > 0, power_heuristic(s.prev_pdf, sky_pdf), 1.0)
    miss = a & ~hit_valid & ~lhit
    radiance = s.radiance + jnp.where(
        (miss & (mis > 0))[:, None], mis[:, None] * sky_color * s.throughput, 0.0
    )

    # --- analytic light hit -> emission, terminate ---
    if light_nee:
        l_em = scene.lights[jnp.maximum(lidx, 0), 4:7]
        light_hit = a & lhit
        radiance = radiance + jnp.where(light_hit[:, None], l_em * s.throughput, 0.0)
    else:
        light_hit = jnp.zeros((b,), bool)

    shade = a & hit_valid & ~lhit

    # --- unified hit frame: ONE material/attribute fetch per transition ---
    # Stage-A lanes read their fresh traversal registers; NEE/BSDF-stage
    # lanes read their saved hit registers. The two populations are
    # disjoint, so a single selected gather+derive serves everyone (the
    # duplicate derives dominated transition cost).
    has_tlas = scene.inst_w2l.shape[0] > 0
    sel_tri = jnp.where(a, s.trav.tri, s.hit_tri)
    sel_bary = jnp.where(a[:, None], bary, s.hit_uv_bary)
    sel_t = jnp.where(a, t_hit, s.hit_t)
    sel_inst = jnp.where(a, s.trav.hit_inst, s.hit_inst)

    attr = jnp.maximum(sel_tri, 0)
    if mask_stale:
        # Lanes that consume the attr row this transition: freshly shaded
        # primary hits, and shadow lanes whose traversal just finished
        # (they re-derive the saved hit's material for the next NEE/BSDF
        # stage).  Everyone else's index goes to the cache-hot row 0; all
        # consumers are masked by shade/env_done/light_done so the film is
        # bit-identical.
        need_mat = (a & hit_valid) | (
            ((s.mode == MODE_SHADOW_ENV) | (s.mode == MODE_SHADOW_LIGHT))
            & shadow_done)
        attr = jnp.where(need_mat, attr, 0)
    oct_mode = int(getattr(config, "attr_compact", 0) or 0) == 3
    if oct_mode:
        # Mode 3: 16-byte rows (3 oct16x2 vertex normals + material), four
        # tris per gathered 64-byte row — quarter the mode-2 footprint
        # (scene._pack_attr_shade_o).  No uv is stored: this path is only
        # valid for untextured, non-normal-mapped configs, where the
        # interpolated uv feeds nothing.
        if config.has_textures or config.has_normal_maps:
            raise ValueError("attr_compact=3 requires has_textures=False "
                             "and has_normal_maps=False (no uv in the "
                             "oct-normal rows); use attr_compact=2")
        if scene.materials.shape[0] > 0x10000:
            raise ValueError("config.attr_compact requires <= 65536 "
                             "materials (the compact rows store a u16 "
                             "index; the scene build degraded the table "
                             "to a placeholder)")
        table = (attr_pair if attr_pair is not None
                 else scene.attr_shade_o.reshape(-1, 16))
        quad = table[attr // 4]                             # (B, 16) u32
        sub = attr % 4
        rowo = jnp.where(
            (sub == 0)[:, None], quad[:, 0:4],
            jnp.where((sub == 1)[:, None], quad[:, 4:8],
                      jnp.where((sub == 2)[:, None], quad[:, 8:12],
                                quad[:, 12:16])))           # (B, 4)

        n0 = _oct_decode(rowo[:, 0])
        n1 = _oct_decode(rowo[:, 1])
        n2 = _oct_decode(rowo[:, 2])
        # Normalize per-vertex BEFORE interpolation (matches the other
        # layouts, which store unit vertex normals).
        n0, n1, n2 = normalize(n0), normalize(n1), normalize(n2)
        w0 = (1.0 - sel_bary[:, 0] - sel_bary[:, 1])[:, None]
        normal = normalize(n0 * w0 + n1 * sel_bary[:, 0:1]
                           + n2 * sel_bary[:, 1:2])
        uv = jnp.zeros((b, 2), jnp.float32)
        mat_idx = rowo[:, 3].astype(jnp.int32)
    elif getattr(config, "attr_compact", False):
        # Compact 32-byte rows: 15 f16 halfwords + u16 material packed in
        # 8 u32 words (scene._pack_attr_shade_c).  Half the table
        # footprint of the f32 rows.
        if scene.materials.shape[0] > 0x10000:
            raise ValueError("config.attr_compact requires <= 65536 "
                             "materials (the compact rows store a u16 "
                             "index; the scene build degraded the table "
                             "to a placeholder)")
        if int(config.attr_compact) == 2:
            # Two triangles per 64-byte row, the same footprint as mode
            # 1; one select picks this tri's 8 words.  attr_pair
            # (config.attr_carry): the same table threaded through the
            # while carry instead of closed over.
            table = (attr_pair if attr_pair is not None
                     else scene.attr_shade_c.reshape(-1, 16))
            pair = table[attr // 2]
            rowc = jnp.where((attr % 2 == 0)[:, None],
                             pair[:, 0:8], pair[:, 8:16])
        else:
            rowc = scene.attr_shade_c[attr]                 # (B, 8) u32
        lo = (rowc & jnp.uint32(0xFFFF)).astype(jnp.uint16)
        hi = (rowc >> jnp.uint32(16)).astype(jnp.uint16)
        half = jnp.stack([lo, hi], axis=-1).reshape(b, 16)  # halfword order
        shade_row = jax.lax.bitcast_convert_type(
            half[:, 0:15], jnp.float16).astype(jnp.float32)   # (B, 15)
    elif getattr(config, "attr_direct", False):
        # Direct per-tri row: same bytes, no packed-row select.  The
        # reshape is loop-invariant (hoisted); rows are bit-identical to
        # the packed layout's selected halves.
        shade_row = scene.attr_shade.reshape(-1, 16)[attr]
    else:
        row3 = scene.attr_shade[attr // 3]      # one gather: 3 tris per row
        sub = attr % 3                          # select this tri's 16 floats
        shade_row = jnp.where(
            (sub == 0)[:, None], row3[:, 0:16],
            jnp.where((sub == 1)[:, None], row3[:, 16:32], row3[:, 32:48]),
        )
    if not oct_mode:
        normal = normalize(_interp(sel_bary, shade_row[:, 0:9], 3))
        uv = _interp(sel_bary, shade_row[:, 9:15], 2)
        if getattr(config, "attr_compact", False):
            mat_idx = half[:, 15].astype(jnp.int32)
        else:
            mat_idx = jax.lax.bitcast_convert_type(shade_row[:, 15], jnp.int32)
    if config.has_normal_maps:
        # Dedicated tangent gather — only compiled in when the scene
        # carries normal maps (static flag).
        tangent = normalize(_interp(
            sel_bary, scene.attr_tangents[attr], 3))
    if has_tlas:
        from unity_webgpu_pathtracer_tpu.render.hitinfo import (
            instance_material_override,
            instance_normal_to_world,
        )

        normal = instance_normal_to_world(scene, sel_inst, normal)
        if config.has_normal_maps:
            tangent = instance_normal_to_world(scene, sel_inst, tangent)
        mat_idx = instance_material_override(scene, sel_inst, mat_idx)
    mdata = gather_small(scene.materials, jnp.maximum(mat_idx, 0))
    if config.has_normal_maps:
        from unity_webgpu_pathtracer_tpu.scene.material import apply_normal_map

        normal = apply_normal_map(mdata, uv, normal, tangent,
                                  scene.texture_data, config.has_textures)
    mat = derive_material(mdata, uv, s.path_d, normal,
                          scene.texture_data, config.has_textures)
    max_roughness = jnp.where(shade, jnp.maximum(s.max_roughness, mat.roughness),
                              s.max_roughness)
    aspect = jnp.sqrt(1.0 - mat.anisotropic * 0.9)
    mat = mat._replace(
        roughness=max_roughness,
        ax=jnp.maximum(0.001, max_roughness / aspect),
        ay=jnp.maximum(0.001, max_roughness * aspect),
    )
    ffnormal = jnp.where(dot1(normal, s.path_d) <= 0.0, normal, -normal)
    position = s.path_o + sel_t[:, None] * s.path_d
    scatter_pos = position + normal * EPSILON

    radiance = radiance + jnp.where(shade[:, None], mat.emission * s.throughput, 0.0)
    over_budget = s.depth >= config.max_bounces
    ended_budget = shade & over_budget
    shade = shade & ~over_budget

    # --- alpha passthrough (pathtrace.hlsl:84-89) ---
    u_alpha, rng_state = urng.random_float(rng_state)
    passthrough = shade & (
        ((mat.alpha_mode == ALPHA_MODE_MASK) & (mat.opacity < mat.alpha_cutoff))
        | ((mat.alpha_mode == ALPHA_MODE_BLEND) & (u_alpha > mat.opacity))
    )
    shade = shade & ~passthrough

    # =====================================================================
    # Stage B/C: shadow traversal finished -> apply pending contribution.
    # =====================================================================
    env_done = (s.mode == MODE_SHADOW_ENV) & shadow_done
    light_done = (s.mode == MODE_SHADOW_LIGHT) & shadow_done
    unoccluded = ~s.trav.found
    radiance = radiance + jnp.where(
        ((env_done | light_done) & unoccluded)[:, None],
        s.pending * s.throughput, 0.0,
    )

    # =====================================================================
    # NEE setups + BSDF sampling, routed per config.
    # =====================================================================
    # Which lanes are entering each NEE stage this transition:
    to_env = shade if env_nee else jnp.zeros((b,), bool)
    to_light_from = env_done if env_nee else shade
    to_light = to_light_from if light_nee else jnp.zeros((b,), bool)
    # Lanes ready for BSDF sampling:
    if light_nee:
        to_bsdf = light_done
    elif env_nee:
        to_bsdf = env_done
    else:
        to_bsdf = shade

    pending = s.pending
    new_mode = s.mode
    sn = s

    # --- env NEE direction/Li (light.hlsl:125-158) ---
    if env_nee:
        if config.has_environment_texture:
            pass  # env_dir/env_li/env_pdf came from the merged env gather
        else:
            (r1, r2), rng_state = urng.random_floats(rng_state, 2)
            env_dir = uniform_sample_sphere(r1, r2)
            env_pdf = jnp.full((b,), 1.0 / (4.0 * PI), jnp.float32)
            env_li = jnp.broadcast_to(
                params.environment_color * params.environment_intensity, (b, 3)
            )

    # --- analytic light NEE direction/Li (light.hlsl:117-173 semantics) ---
    if light_nee:
        lcount = scene.lights.shape[0]
        u_pick, rng_state = urng.random_float(rng_state)
        li_idx = jnp.clip((u_pick * lcount).astype(jnp.int32), 0, lcount - 1)
        rec = gather_small(scene.lights, li_idx)
        ltype = rec[:, 3].astype(jnp.int32)
        lpos, lu, lv = rec[:, 0:3], rec[:, 8:11], rec[:, 12:15]
        emission = rec[:, 4:7] * float(lcount)
        lrange, larea = rec[:, 7], rec[:, 11]
        (r1, r2), rng_state = urng.random_floats(rng_state, 2)
        rect_surface = lpos + lu * r1[:, None] + lv * r2[:, None]
        to_rect = rect_surface - scatter_pos
        rect_dist = length(to_rect)
        rect_dir = to_rect / jnp.maximum(rect_dist, 1e-20)[:, None]
        rect_normal = normalize(cross(lu, lv))
        rect_pdf = rect_dist**2 / jnp.maximum(
            larea * jnp.abs(dot(rect_normal, rect_dir)), 1e-20
        )
        to_l = lpos - scatter_pos
        delta_dist = length(to_l)
        delta_dir = to_l / jnp.maximum(delta_dist, 1e-20)[:, None]
        is_rect = ltype == LIGHT_TYPE_RECTANGLE
        is_spot = ltype == LIGHT_TYPE_SPOT
        is_point = ltype == LIGHT_TYPE_POINT
        light_dir = jnp.where(is_rect[:, None], rect_dir, delta_dir)
        ldist = jnp.where(is_rect, rect_dist, delta_dist)
        lnormal = jnp.where(is_rect[:, None], rect_normal,
                            jnp.where(is_spot[:, None], normalize(lu), -delta_dir))
        lpdf2 = jnp.where(is_rect, rect_pdf, 0.0)
        falloff = _unity_falloff(ldist, lrange)
        cos_t = dot(-light_dir, normalize(lnormal))
        falloff = jnp.where(is_rect & (cos_t < 0), 0.0, falloff)
        cos_outer, cos_inner = rec[:, 12], rec[:, 13]
        spot_fade = spot_cone_fade(cos_t, cos_outer, cos_inner)
        falloff = jnp.where(is_spot, falloff * spot_fade, falloff)

    # --- merged NEE eval: to_env and to_light lanes are disjoint, so ONE
    # eval_brdf serves both (env evaluates about ffnormal, analytic lights
    # about the raw normal — the reference's asymmetry, light.hlsl:105/134).
    if env_nee and light_nee:
        l_eval = jnp.where(to_light[:, None], light_dir, env_dir)
        n_eval = jnp.where(to_light[:, None], normal, ffnormal)
        f_u, bpdf_u = ubsdf.eval_brdf(mat, -s.path_d, n_eval, l_eval)
    elif env_nee:
        f_u, bpdf_u = ubsdf.eval_brdf(mat, -s.path_d, ffnormal, env_dir)
    elif light_nee:
        f_u, bpdf_u = ubsdf.eval_brdf(mat, -s.path_d, normal, light_dir)

    if env_nee:
        mis_e = power_heuristic(env_pdf, bpdf_u)
        contrib = (
            mis_e[:, None] * env_li * f_u
            / jnp.maximum(env_pdf, 1e-20)[:, None]
        )
        ok = (bpdf_u > 0) & (env_pdf > 0) & (mis_e > 0)
        pending = jnp.where(to_env[:, None], jnp.where(ok[:, None], contrib, 0.0), pending)
        sn = _set_trav(sn, to_env, scatter_pos, env_dir, jnp.float32(FAR_PLANE), entry)
        new_mode = jnp.where(to_env, MODE_SHADOW_ENV, new_mode)

    if light_nee:
        contrib_l = emission * falloff[:, None] * f_u / jnp.where(
            lpdf2 > 0, lpdf2, 1.0
        )[:, None]
        ok_l = (is_rect | is_spot | is_point) & (falloff > 0)
        pending = jnp.where(to_light[:, None],
                            jnp.where(ok_l[:, None], contrib_l, 0.0), pending)
        sn = _set_trav(sn, to_light, scatter_pos, light_dir, ldist - EPSILON, entry)
        new_mode = jnp.where(to_light, MODE_SHADOW_LIGHT, new_mode)

    # --- BSDF sample + Russian roulette -> next bounce or death ---
    pos_b = position
    f_s, l_s, pdf_s, rng_state = ubsdf.sample_brdf(mat, -s.path_d, ffnormal, rng_state)
    nan_f = jnp.isnan(f_s)
    nan_lane = nan_f[:, 0] | nan_f[:, 1] | nan_f[:, 2] | jnp.isnan(pdf_s)
    sample_ok = to_bsdf & ~nan_lane & (pdf_s > 0.0)
    throughput = jnp.where(
        sample_ok[:, None],
        s.throughput * f_s / jnp.maximum(pdf_s, 1e-20)[:, None],
        s.throughput,
    )
    continue_ray = sample_ok
    if config.use_russian_roulette:
        u_rr, rng_state = urng.random_float(rng_state)
        t_max3 = jnp.maximum(jnp.maximum(throughput[:, 0], throughput[:, 1]),
                             throughput[:, 2])
        p_cont = jnp.minimum(t_max3 + 0.001, 0.95)
        rr_kill = continue_ray & (u_rr >= p_cont)
        throughput = jnp.where(
            (continue_ray & ~rr_kill)[:, None], throughput / p_cont[:, None], throughput
        )
        continue_ray = continue_ray & ~rr_kill

    # --- stitch next state ---
    # The lane cap bounds *processed stage-transitions* per path (its only
    # job is stopping infinite alpha-passthrough loops, pathtrace.hlsl:84);
    # lanes merely waiting in traversal must NOT consume budget — on large
    # scenes a traversal segment spans many loop iterations.
    processed = a | env_done | light_done
    cap_exhausted = processed & (s.lane_cap <= 0)
    # Deaths this transition:
    died = (
        miss | light_hit | ended_budget
        | (to_bsdf & ~continue_ray)
        | cap_exhausted
    )
    # Death radiance with firefly clamp.
    rad_out = radiance
    if config.use_firefly_filter:
        lum = luminance(rad_out)
        scale = jnp.where(lum > params.max_firefly_luminance,
                          params.max_firefly_luminance / jnp.maximum(lum, 1e-20), 1.0)
        rad_out = rad_out * scale[:, None]
    if config.debug_nan_canary:
        # NaN-BSDF canary (pathtrace.hlsl:100-104): the sample's radiance
        # is REPLACED by pure green, making NaN sources visible in the
        # image. Off by default: production drops the sample's bounce
        # instead (the accumulated prefix radiance still splats).
        rad_out = jnp.where((to_bsdf & nan_lane)[:, None],
                            jnp.array([0.0, 1.0, 0.0], jnp.float32), rad_out)

    # Continuing bounce: new primary ray (position comes from the unified
    # hit frame for both passthrough and BSDF continuation). A cap-exhausted
    # lane must die even if it would otherwise pass through (that is the
    # loop the cap exists to break).
    new_dir = jnp.where(passthrough[:, None], s.path_d, l_s)
    bounce = (continue_ray | passthrough) & ~died
    new_origin = pos_b + new_dir * EPSILON
    path_o = jnp.where(bounce[:, None], new_origin, s.path_o)
    path_d = jnp.where(bounce[:, None], new_dir, s.path_d)
    sn = _set_trav(sn, bounce, path_o, path_d, jnp.float32(FAR_PLANE), entry)
    new_mode = jnp.where(bounce, MODE_PRIMARY, jnp.where(died, MODE_DEAD, new_mode))
    depth = jnp.where(continue_ray, s.depth + 1, s.depth)
    prev_pdf = jnp.where(to_bsdf, pdf_s, s.prev_pdf)

    # Save primary-hit registers for lanes that just shaded.
    saved = shade | passthrough
    hit_t = jnp.where(saved, t_hit, s.hit_t)
    hit_bary = jnp.where(saved[:, None], bary, s.hit_uv_bary)
    hit_tri = jnp.where(saved, s.trav.tri, s.hit_tri)
    hit_inst = jnp.where(saved, s.trav.hit_inst, s.hit_inst)

    pixel_base, npix_l, sample_base = shard
    dead_now = new_mode == MODE_DEAD
    spp_l = budget // npix_l

    if config.use_lane_film:
        # ---- chunked lane accumulation + deferred flush ----
        # The shared work queue hands out CHUNKS of `ch` consecutive
        # samples of one pixel (dynamic balancing exactly like the sample
        # queue; fixed lane->pixel ownership would leave lanes idle).
        # Deaths accumulate radiance in-lane; a completed chunk writes ONE
        # (pixel, rgb) flush-slot record, and the outer pass loop scatters
        # all B slots every M <= ch super-iterations — ~ch x fewer scatter
        # updates.  A lane can complete at most one chunk per M transitions
        # (each sample needs >= 1 transition), so one slot per lane
        # suffices.  Seeds stay (global pixel, global sample): per-sample
        # radiance is bit-identical to the legacy path; only scatter-add
        # association differs.
        ch = _chunk_size(config, spp_l)
        accum = s.accum + jnp.where(died[:, None], rad_out, 0.0)
        chunk_done = died & (s.samp_i >= ch - 1)
        pix_local = s.pixel - jnp.asarray(pixel_base, jnp.int32)
        # Empty slot sentinel = npix_l (JAX scatter drops OOB); -1 would
        # WRAP to the last film row.
        flush_pix = jnp.where(chunk_done, pix_local, s.flush_pix)
        flush_rgb = jnp.where(chunk_done[:, None], accum, s.flush_rgb)
        accum = jnp.where(chunk_done[:, None], 0.0, accum)

        chunks_total = npix_l * (spp_l // ch)
        need_chunk = dead_now & (s.samp_i >= ch - 1)
        remaining = chunks_total - s.queue_head
        rank = jnp.cumsum(need_chunk.astype(jnp.int32)) - 1
        chunk_id = s.queue_head + rank
        take_next = need_chunk & (rank < remaining)
        take_same = dead_now & (s.samp_i < ch - 1)
        take = take_next | take_same
        samp_i = jnp.where(take_next, 0,
                           jnp.where(take_same, s.samp_i + 1, s.samp_i))
        samp_i_base = jnp.where(
            take_next, (chunk_id // npix_l) * ch, s.samp_i_base)
        pixel_new = jnp.where(
            take_next, (chunk_id % npix_l),
            jnp.maximum(pix_local, 0)).astype(jnp.uint32) + jnp.asarray(
            pixel_base, jnp.uint32)
        sample_new = (
            (samp_i_base + samp_i).astype(jnp.uint32)
            + jnp.asarray(current_sample, jnp.uint32)
            + jnp.asarray(sample_base, jnp.uint32)
        )
        film = s.film
        queue_head = s.queue_head + jnp.minimum(
            jnp.sum(need_chunk.astype(jnp.int32)), remaining)
    elif config.use_record_film:
        # ---- record film: append, don't scatter ----
        # Identical rank-gate + sort compaction to the sorted-prefix film
        # below, but the K-prefix is APPENDED to the pass-lifetime record
        # buffer with one dynamic_update_slice (a contiguous in-place
        # write on the aliased while carry) instead of scattered.  The cursor
        # advances by the ACCEPTED count only, so the garbage tail of this
        # block (keys >= npix) is overwritten by the next append; the
        # final block's tail sorts to the back of the end-of-pass resolve.
        pix_local = s.pixel - jnp.asarray(shard[0], jnp.int32)
        k_slots = max(b >> config.film_k_shift, 1)
        emit = died | s.rec_pending
        if k_slots >= b:
            # K = B: every record fits in the appended block — no rank
            # gate, no backpressure (statically removes the cumsum).
            accepted = emit
        else:
            rank_e = jnp.cumsum(emit.astype(jnp.int32)) - 1
            accepted = emit & (rank_e < k_slots)
        key = jnp.where(accepted, pix_local,
                        npix_l + jnp.arange(b, dtype=jnp.int32))
        if config.film_sort_perm:
            ks, perm = jax.lax.sort(
                (key, jnp.arange(b, dtype=jnp.int32)), num_keys=1)
            p = perm[:k_slots]
            r0, r1, r2 = (rad_out[:, 0][p], rad_out[:, 1][p],
                          rad_out[:, 2][p])
        else:
            ks, r0, r1, r2 = jax.lax.sort(
                (key, rad_out[:, 0], rad_out[:, 1], rad_out[:, 2]),
                num_keys=1)
            r0, r1, r2 = r0[:k_slots], r1[:k_slots], r2[:k_slots]
        rec_keys = jax.lax.dynamic_update_slice(
            s.rec_keys, ks[:k_slots], (s.rec_cursor,))
        rec_v0 = jax.lax.dynamic_update_slice(s.rec_v0, r0, (s.rec_cursor,))
        rec_v1 = jax.lax.dynamic_update_slice(s.rec_v1, r1, (s.rec_cursor,))
        rec_v2 = jax.lax.dynamic_update_slice(s.rec_v2, r2, (s.rec_cursor,))
        rec_cursor = s.rec_cursor + jnp.sum(accepted.astype(jnp.int32))
        rec_pending = emit & ~accepted
        film = s.film  # (1,3) dummy; the film materializes at resolve

        avail = dead_now & ~rec_pending
        remaining = budget - s.queue_head
        rank = jnp.cumsum(avail.astype(jnp.int32)) - 1
        work_id = s.queue_head + rank
        take = avail & (rank < remaining)
        pixel_new = (work_id % npix_l).astype(jnp.uint32) + jnp.asarray(pixel_base, jnp.uint32)
        sample_new = (
            (work_id // npix_l).astype(jnp.uint32)
            + jnp.asarray(current_sample, jnp.uint32)
            + jnp.asarray(sample_base, jnp.uint32)
        )
        queue_head = s.queue_head + jnp.minimum(jnp.sum(avail.astype(jnp.int32)), remaining)
        accum, samp_i, samp_i_base = s.accum, s.samp_i, s.samp_i_base
        flush_pix, flush_rgb = s.flush_pix, s.flush_rgb
        radiance_next = jnp.where(
            (accepted | take)[:, None], 0.0,
            jnp.where(rec_pending[:, None], rad_out, radiance))
    elif config.use_sorted_film:
        # ---- sorted-prefix film: K scatter slots instead of B ----
        # The legacy film issues B scatter slots per transition (OOB drops
        # included) for the fraction of lanes that actually died.  Accept
        # at most K = b >> film_k_shift records (rank-gated BEFORE the
        # sort so nothing is ever lost), compact them to the front with
        # one lax.sort and scatter only that prefix.  Rejected lanes park their (clamped)
        # radiance in-lane, skip regeneration, and retry next transition;
        # the pass loop flushes stragglers after the while loop.
        pix_local = s.pixel - jnp.asarray(shard[0], jnp.int32)
        k_slots = max(b >> config.film_k_shift, 1)
        emit = died | s.rec_pending
        rank_e = jnp.cumsum(emit.astype(jnp.int32)) - 1
        accepted = emit & (rank_e < k_slots)
        # Invalid rows get DISTINCT ascending OOB keys (npix + lane): they
        # sort after every valid pixel, and any that land inside the
        # prefix are dropped by the scatter without duplicate
        # serialization.
        key = jnp.where(accepted, pix_local,
                        npix_l + jnp.arange(b, dtype=jnp.int32))
        if config.film_sort_perm:
            ks, perm = jax.lax.sort(
                (key, jnp.arange(b, dtype=jnp.int32)), num_keys=1)
            pre = rad_out[perm[:k_slots]]
        else:
            ks, r0, r1, r2 = jax.lax.sort(
                (key, rad_out[:, 0], rad_out[:, 1], rad_out[:, 2]),
                num_keys=1)
            pre = jnp.stack([r0[:k_slots], r1[:k_slots], r2[:k_slots]],
                            axis=1)
        # The prefix keys come straight out of lax.sort — tell the scatter
        # so XLA can take its sorted-indices path (duplicates remain, so
        # unique_indices stays False).
        film = s.film.at[ks[:k_slots]].add(pre, indices_are_sorted=True)
        rec_pending = emit & ~accepted

        avail = dead_now & ~rec_pending
        remaining = budget - s.queue_head
        rank = jnp.cumsum(avail.astype(jnp.int32)) - 1
        work_id = s.queue_head + rank
        take = avail & (rank < remaining)
        pixel_new = (work_id % npix_l).astype(jnp.uint32) + jnp.asarray(pixel_base, jnp.uint32)
        sample_new = (
            (work_id // npix_l).astype(jnp.uint32)
            + jnp.asarray(current_sample, jnp.uint32)
            + jnp.asarray(sample_base, jnp.uint32)
        )
        queue_head = s.queue_head + jnp.minimum(jnp.sum(avail.astype(jnp.int32)), remaining)
        accum, samp_i, samp_i_base = s.accum, s.samp_i, s.samp_i_base
        flush_pix, flush_rgb = s.flush_pix, s.flush_rgb
        # Parked lanes store the firefly-clamped/canary value so the
        # eventual flush (next acceptance or post-loop) is identical to an
        # immediate splat; clamping is idempotent.
        radiance_next = jnp.where(
            (accepted | take)[:, None], 0.0,
            jnp.where(rec_pending[:, None], rad_out, radiance))
    else:
        # ---- legacy shared work queue + scatter-add film ----
        # Film rows are shard-local; s.pixel is global. Lanes that did NOT
        # die are routed out-of-bounds and dropped by the scatter (JAX's
        # default out-of-bounds drop semantics); routing them to pixel 0
        # with a zero value instead would make most updates duplicates of
        # one row.  Each dropped lane gets a DISTINCT OOB index (npix +
        # lane): a single shared sentinel is itself a mass duplicate.
        pix_local = s.pixel - jnp.asarray(shard[0], jnp.int32)
        oob = s.film.shape[0] + jnp.arange(b, dtype=jnp.int32)
        film = s.film.at[jnp.where(died, pix_local, oob)].add(rad_out)
        remaining = budget - s.queue_head
        rank = jnp.cumsum(dead_now.astype(jnp.int32)) - 1
        work_id = s.queue_head + rank
        take = dead_now & (rank < remaining)
        pixel_new = (work_id % npix_l).astype(jnp.uint32) + jnp.asarray(pixel_base, jnp.uint32)
        sample_new = (
            (work_id // npix_l).astype(jnp.uint32)
            + jnp.asarray(current_sample, jnp.uint32)
            + jnp.asarray(sample_base, jnp.uint32)
        )
        queue_head = s.queue_head + jnp.minimum(jnp.sum(dead_now.astype(jnp.int32)), remaining)
        accum, samp_i, samp_i_base = s.accum, s.samp_i, s.samp_i_base
        flush_pix, flush_rgb = s.flush_pix, s.flush_rgb

    record_mode = config.use_record_film and not config.use_lane_film
    if config.use_lane_film or not (config.use_sorted_film
                                    or config.use_record_film):
        # Branches other than the sorted/record films (lane film takes the
        # dispatch over both) carry these through unchanged.
        rec_pending = s.rec_pending
        radiance_next = jnp.where((died | take)[:, None], 0.0, radiance)
    if not record_mode:
        rec_keys, rec_cursor = s.rec_keys, s.rec_cursor
        rec_v0, rec_v1, rec_v2 = s.rec_v0, s.rec_v1, s.rec_v2

    rng_new = urng.seed(pixel_new, sample_new, params.seed_root)
    coords, rng_new = ucamera.jittered_pixel_coords(pixel_new, config, rng_new)
    o_new, d_new, rng_new = ucamera.get_screen_ray(coords, config, params, rng_new)
    tk = take[:, None]
    path_o = jnp.where(tk, o_new, path_o)
    path_d = jnp.where(tk, d_new, path_d)
    sn = _set_trav(sn, take, path_o, path_d, jnp.float32(FAR_PLANE), entry)
    new_mode = jnp.where(take, MODE_PRIMARY, new_mode)

    shadow_started = (to_env if env_nee else jnp.zeros((b,), bool)) | (
        to_light if light_nee else jnp.zeros((b,), bool)
    )
    rays = s.rays + jnp.sum((bounce | take).astype(jnp.int32)) + jnp.sum(
        shadow_started.astype(jnp.int32)
    )

    return sn._replace(
        mode=new_mode,
        path_o=path_o,
        path_d=path_d,
        hit_t=hit_t,
        hit_uv_bary=hit_bary,
        hit_tri=hit_tri,
        hit_inst=hit_inst,
        pending=pending,
        throughput=jnp.where(take[:, None], 1.0, throughput),
        radiance=radiance_next,
        rng=jnp.where(take, rng_new, rng_state),
        pixel=jnp.where(take, pixel_new.astype(jnp.int32), s.pixel),
        depth=jnp.where(take, 0, depth),
        max_roughness=jnp.where(take, 0.0, max_roughness),
        prev_pdf=jnp.where(take, 0.0, prev_pdf),
        lane_cap=jnp.where(
            take,
            3 * (config.max_bounces + 2) + 32,
            jnp.where(processed, s.lane_cap - 1, s.lane_cap),
        ),
        film=film,
        queue_head=queue_head,
        rays=rays,
        accum=accum,
        samp_i=samp_i,
        samp_i_base=samp_i_base,
        flush_pix=flush_pix,
        flush_rgb=flush_rgb,
        rec_pending=rec_pending,
        rec_keys=rec_keys,
        rec_v0=rec_v0, rec_v1=rec_v1, rec_v2=rec_v2,
        rec_cursor=rec_cursor,
    )


def fused_pass_with_stats(scene, config: RenderConfig, params: RenderParams,
                          current_sample, pool_size: int | None = None,
                          shard=None):
    """Render one pass; returns ``(film_sum, occupancy, rays, arrivals)``.

    ``shard`` (multichip): ``(pixel_base, npix_local, sample_base,
    spp_local)`` — the shard renders pixels ``[pixel_base, pixel_base +
    npix_local)`` with samples offset by ``sample_base``; film rows are
    shard-local. ``npix_local``/``spp_local`` must be Python ints.
    """
    if shard is None:
        npix_l = config.pixel_count()
        spp_l = config.samples_per_pass
        shard_t = None
    else:
        pixel_base, npix_l, sample_base, spp_l = shard
        shard_t = (pixel_base, npix_l, sample_base)
    budget = npix_l * spp_l
    # Auto pool: 96k lanes (3 << 15), or the whole budget when smaller.
    # Any pool size is legal: per-sample radiance is keyed on (pixel,
    # sample) seeds, and the lanes just drain the same work queue.
    b = pool_size or config.pool_size or min(budget, 3 << 15)
    use_v2 = config.traversal == "wide2"
    use_v8 = config.traversal == "wide8"
    use_v16 = config.traversal == "wide16"

    if use_v16:
        from unity_webgpu_pathtracer_tpu.ops import traverse_wide16 as tw16

        nodes16 = scene.wide16_nodes
        entry = None
        trav0 = tw16.init_state16(b, jnp.float32(0.0), ptr0=tw16.DONE,
                                  depth=scene.stack_levels.shape[0])
    elif use_v8:
        from unity_webgpu_pathtracer_tpu.ops import traverse_wide8 as tw8

        nodes8 = scene.wide8_nodes
        entry = None
        trav0 = tw8.init_state8(b, jnp.float32(0.0), ptr0=tw8.DONE,
                                depth=scene.stack_levels.shape[0])
    elif use_v2:
        from unity_webgpu_pathtracer_tpu.ops import traverse_wide2 as tw2

        inner_flat, n_inner, n_orders, leaf_geo, n_leaf, skip_flat = tw2._tables(scene)
        entry = scene.wide2_entry
        trav0 = tw2.init_state2(b, jnp.float32(0.0), jnp.asarray(0, jnp.int32))
    else:
        nodes = scene.wide_nodes
        n_orders, n_nodes = nodes.shape[0], nodes.shape[1]
        nodes_flat = nodes.reshape(n_orders * n_nodes, nodes.shape[2])
        entry = None
        from unity_webgpu_pathtracer_tpu.ops.traverse_wide import init_state

        trav0 = init_state(b, jnp.float32(0.0))._replace(
            ptr=jnp.full((b,), n_nodes, jnp.int32))

    lane_film = config.use_lane_film
    record_film = config.use_record_film and not lane_film
    spp_l_ = budget // npix_l
    ch_ = _chunk_size(config, spp_l_)
    z3 = jnp.zeros((b, 3), jnp.float32)
    zi = jnp.zeros((b,), jnp.int32)
    zf = jnp.zeros((b,), jnp.float32)
    if record_film:
        # budget rows of real records + a pool-sized block for the final
        # append's garbage tail (the post-loop straggler append writes a
        # full b-row block).  Never-written rows keep the 2**30 sentinel
        # key and sort behind every valid pixel.
        rec_cap = budget + b
        rec_keys0 = jnp.full((rec_cap,), 1 << 30, jnp.int32)
        rec_ch0 = jnp.zeros((rec_cap,), jnp.float32)
        film0 = jnp.zeros((1, 3), jnp.float32)
    else:
        rec_keys0 = jnp.zeros((1,), jnp.int32)
        rec_ch0 = jnp.zeros((1,), jnp.float32)
        film0 = jnp.zeros((npix_l, 3), jnp.float32)
    init = FusedState(
        mode=jnp.full((b,), MODE_DEAD, jnp.int32),
        trav=trav0,
        trav_o=z3, trav_d=z3.at[:, 2].set(1.0),
        path_o=z3, path_d=z3.at[:, 2].set(1.0),
        hit_t=zf, hit_uv_bary=jnp.zeros((b, 2), jnp.float32),
        hit_tri=jnp.full((b,), -1, jnp.int32),
        hit_inst=jnp.full((b,), -1, jnp.int32),
        pending=z3, throughput=z3, radiance=z3,
        rng=jnp.zeros((b,), jnp.uint32), pixel=zi, depth=zi,
        max_roughness=zf, prev_pdf=zf, lane_cap=zi,
        film=film0,
        queue_head=jnp.asarray(0, jnp.int32),
        arrivals=jnp.asarray(0, jnp.uint32),
        rays=jnp.asarray(0, jnp.int32),
        busy=jnp.asarray(0, jnp.int32),
        ticks=jnp.asarray(0, jnp.int32),
        # Bootstrap: lanes sit at "last sample of a finished chunk" so the
        # first transition's regeneration pulls real chunks off the queue.
        accum=z3,
        samp_i=jnp.full((b,), ch_ - 1, jnp.int32),
        samp_i_base=zi,
        # Distinct OOB sentinels (npix + lane): a shared sentinel is a mass
        # duplicate the scatter serializes before dropping.
        flush_pix=npix_l + jnp.arange(b, dtype=jnp.int32),
        flush_rgb=z3,
        rec_pending=jnp.zeros((b,), bool),
        rec_keys=rec_keys0,
        rec_v0=rec_ch0, rec_v1=rec_ch0, rec_v2=rec_ch0,
        rec_cursor=jnp.asarray(0, jnp.int32),
    )

    def cond(s: FusedState):
        if lane_film:
            # All lanes start DEAD; tick 0 bootstraps the regeneration.
            return (s.ticks == 0) | jnp.any(s.mode != MODE_DEAD)
        return jnp.any(s.mode != MODE_DEAD) | (s.queue_head < budget)

    inst_w2l = scene.inst_w2l if scene.inst_w2l.shape[0] > 0 else None

    has_inst = inst_w2l is not None

    te = getattr(config, "transition_every", TRANSITION_EVERY) or TRANSITION_EVERY

    def body(s: FusedState, attr_pair=None, nodes_c=None, env_rows_c=None):
        # nodes_c / env_rows_c (config.node_carry / env_carry): the same
        # tables threaded through the while carry instead of closed over
        # (the attr_carry pattern).
        n16 = nodes_c if nodes_c is not None else (nodes16 if use_v16 else None)
        sc = scene
        if env_rows_c is not None:
            sc = scene._replace(env=scene.env._replace(merged_rows=env_rows_c))
        inv = safe_rcp(s.trav_d)
        shadowing = (s.mode == MODE_SHADOW_ENV) | (s.mode == MODE_SHADOW_LIGHT)
        trav = s.trav
        # Named scopes give every layer's kernels a stable op_name prefix
        # for the profiler-trace reduction (chip_smoke.py).
        with jax.named_scope("arrival"):
            if use_v16:
                def arrive(tr):
                    active = (s.mode != MODE_DEAD) & ~(shadowing & tr.found)
                    return tw16.arrival_step16(n16, s.trav_o, s.trav_d, inv,
                                               tr, active,
                                               has_instances=has_inst)

                if getattr(config, "arrival_fori", False):
                    # One arrival in HLO, iterated te times by a fori_loop:
                    # a ~te-x smaller traversal graph (compile-time lever);
                    # the per-lane arithmetic is identical.
                    trav = jax.lax.fori_loop(0, te, lambda _i, tr: arrive(tr),
                                             trav)
                else:
                    for _ in range(te):
                        trav = arrive(trav)
                stepping = (s.mode != MODE_DEAD) & (s.trav.ptr >= 0)
                trav_done = trav.ptr < 0
            elif use_v8:
                for _ in range(te):
                    active = (s.mode != MODE_DEAD) & ~(shadowing & trav.found)
                    trav = tw8.arrival_step8(nodes8, s.trav_o, s.trav_d, inv,
                                             trav, active,
                                             has_instances=has_inst)
                stepping = (s.mode != MODE_DEAD) & (s.trav.ptr >= 0)
                trav_done = trav.ptr < 0
            elif use_v2:
                oct_ = octant_index(s.trav_d) % n_orders
                base = oct_ * n_inner
                skip_base = oct_ * n_leaf
                for _ in range(te):
                    active = (s.mode != MODE_DEAD) & ~(shadowing & trav.found)
                    trav = tw2.node_step2(inner_flat, n_inner, base, s.trav_o,
                                          s.trav_d, inv, trav, active, inst_w2l)
                active = (s.mode != MODE_DEAD) & ~(shadowing & trav.found)
                trav = tw2.leaf_step2(leaf_geo, skip_flat, n_leaf, skip_base,
                                      s.trav_o, s.trav_d, trav, active,
                                      inst_w2l)
                stepping = (s.mode != MODE_DEAD) & tw2.live2(s.trav)
                trav_done = ~tw2.live2(trav)
            else:
                oct_ = octant_index(s.trav_d) % n_orders
                base = oct_ * n_nodes
                for _ in range(te):
                    active = (s.mode != MODE_DEAD) & ~(shadowing & trav.found)
                    trav = arrival_step(nodes_flat, n_nodes, base, s.trav_o,
                                        s.trav_d, inv, trav, active, inst_w2l)
                stepping = (s.mode != MODE_DEAD) & (s.trav.ptr < n_nodes)
                trav_done = trav.ptr >= n_nodes
        s = s._replace(
            trav=trav,
            arrivals=s.arrivals
            + jnp.uint32(te) * jnp.sum(stepping.astype(jnp.uint32)),
            busy=s.busy + jnp.sum((s.mode != MODE_DEAD).astype(jnp.int32)),
            ticks=s.ticks + b,
        )
        with jax.named_scope("transition"):
            s = _transition(sc, config, params, s, budget, current_sample,
                            trav_done, entry, shard_t, attr_pair=attr_pair)
        if use_v16 and config.use_prestep:
            # Fresh segments (regen/bounce/NEE shadow) all sit at the root;
            # descend their first level(s) gather-free (prestep16).
            with jax.named_scope("prestep"):
                fresh = ((s.trav.ptr == 0) & (s.trav.pend == tw16.FULL)
                         & (s.trav.sp == 0) & (s.mode != MODE_DEAD))
                top3 = (scene.wide16_top3
                        if getattr(config, "prestep_levels", 2) >= 3 else None)
                s = s._replace(trav=tw16.prestep16(
                    n16, scene.wide16_top, s.trav_o, s.trav_d,
                    safe_rcp(s.trav_d), s.trav, fresh, top3=top3))
        return s

    if lane_film:
        # ONE flat while with the flush fused into every super-iteration
        # (no nested while or lax.cond around the flush).  The scatter is
        # kept cheap by DISTINCT out-of-bounds sentinels (see the
        # flush_pix init).
        def body_flush(s, **table_kw):
            s = body(s, **table_kw)
            film = s.film.at[s.flush_pix].add(s.flush_rgb)
            return s._replace(
                film=film,
                flush_pix=npix_l + jnp.arange(b, dtype=jnp.int32),
                flush_rgb=jnp.zeros_like(s.flush_rgb),
            )

        inner_body = body_flush
    else:
        inner_body = body
    attr_mode = int(getattr(config, "attr_compact", 0) or 0)
    attr_carry = getattr(config, "attr_carry", False) and attr_mode in (2, 3)
    # Carry-threaded tables: lets XLA choose each table's gather layout
    # once at loop entry instead of per super-iteration.  Mode 3 carries
    # its own (T/4, 16) u32 oct table the same way.
    carry_kw = []
    if attr_carry:
        carry_kw.append(("attr_pair",
                         (scene.attr_shade_c if attr_mode == 2
                          else scene.attr_shade_o).reshape(-1, 16)))
    if use_v16 and getattr(config, "node_carry", False):
        carry_kw.append(("nodes_c", nodes16))
    if getattr(config, "env_carry", False) and scene.env.merged_rows.shape[0] > 1:
        carry_kw.append(("env_rows_c", scene.env.merged_rows))
    if carry_kw:
        names = tuple(k for k, _ in carry_kw)
        tabs0 = tuple(v for _, v in carry_kw)
        final, _ = jax.lax.while_loop(
            lambda c: cond(c[0]),
            lambda c: (inner_body(c[0], **dict(zip(names, c[1]))), c[1]),
            (init, tabs0))
    else:
        final = jax.lax.while_loop(cond, inner_body, init)
    if record_film:
        # Straggler append (lanes whose last record was rank-rejected on
        # the final transition), then the resolve: ONE global sort groups
        # the exactly-budget valid records by pixel; since the work queue
        # is pixel-major, every pixel owns exactly spp_l of them and a
        # dense reshape-sum produces the film with no scatter at all.
        base = 0 if shard_t is None else shard_t[0]
        pixf = final.pixel - jnp.asarray(base, jnp.int32)
        key = jnp.where(final.rec_pending, pixf, jnp.int32(1 << 30))
        ks, r0, r1, r2 = jax.lax.sort(
            (key, final.radiance[:, 0], final.radiance[:, 1],
             final.radiance[:, 2]), num_keys=1)
        rec_keys = jax.lax.dynamic_update_slice(
            final.rec_keys, ks, (final.rec_cursor,))
        rec_v0 = jax.lax.dynamic_update_slice(
            final.rec_v0, r0, (final.rec_cursor,))
        rec_v1 = jax.lax.dynamic_update_slice(
            final.rec_v1, r1, (final.rec_cursor,))
        rec_v2 = jax.lax.dynamic_update_slice(
            final.rec_v2, r2, (final.rec_cursor,))
        _, v0, v1, v2 = jax.lax.sort(
            (rec_keys, rec_v0, rec_v1, rec_v2), num_keys=1)
        film = jnp.stack(
            [v0[:budget].reshape(npix_l, spp_l_).sum(axis=1),
             v1[:budget].reshape(npix_l, spp_l_).sum(axis=1),
             v2[:budget].reshape(npix_l, spp_l_).sum(axis=1)], axis=1)
        final = final._replace(film=film)
    elif config.use_sorted_film and not config.use_lane_film:
        # Straggler flush: lanes whose last death record was rank-rejected
        # on the final transition still hold their (clamped) radiance.
        base = 0 if shard_t is None else shard_t[0]
        pixf = final.pixel - jnp.asarray(base, jnp.int32)
        oobf = npix_l + jnp.arange(b, dtype=jnp.int32)
        film = final.film.at[jnp.where(final.rec_pending, pixf, oobf)].add(
            final.radiance)
        final = final._replace(film=film)
    occupancy = final.busy.astype(jnp.float32) / jnp.maximum(
        final.ticks.astype(jnp.float32), 1.0
    )
    return final.film, occupancy, final.rays, final.arrivals


@functools.partial(jax.jit, static_argnums=(1,))
def fused_pass_and_accumulate(scene, config: RenderConfig,
                              params: RenderParams, film: ufilm.Film):
    """One progressive pass accumulated into ``film``.

    Returns ``(film, occupancy, rays, arrivals)`` — the pass stats ride
    along as three scalars (they are already computed inside the pass;
    the viewer's live stats panel reads them, Graphy analogue
    ``GraphyManager.cs:32``).  Callers that only want the film take
    ``[0]``."""
    total, occ, rays, arr = fused_pass_with_stats(scene, config, params,
                                                  jnp.max(film.sample_count))
    total = total.reshape(config.height, config.width, 3)
    return ufilm.accumulate(film, total, config.samples_per_pass), occ, rays, arr
