"""Disney-style 5-lobe BSDF (diffuse+retro+subsurface+sheen, dielectric GGX
reflection, metallic GGX reflection, glass reflect/refract, clearcoat GTR1).

Vectorized, branch-free port of ``Assets/Resources/util/brdf.hlsl``: the
reference evaluates lobes under scalar ``if (pr > 0 && reflect)`` guards
(:160-220); here every lobe is evaluated for the whole ray batch and gated
with ``jnp.where`` — a batched program executes all lanes anyway, so the
guards become masks and every division is made safe so masked lanes cannot generate NaNs
that would poison live lanes.

Conventions match the reference: all lobe math happens in the tangent frame
of the shading normal (z = N); ``V`` points away from the surface; ``eta`` is
the relative IOR for the current hemisphere (``material.hlsl:135``).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from unity_webgpu_pathtracer_tpu.utils import rng as urng
from unity_webgpu_pathtracer_tpu.utils.math import (
    INV_PI,
    build_onb,
    dot,
    luminance,
    normalize,
    reflect,
    refract,
    to_local,
    to_world,
)
from unity_webgpu_pathtracer_tpu.render.sampling import (
    dielectric_fresnel,
    cosine_sample_hemisphere,
    gtr1,
    gtr2_aniso,
    sample_ggx_vndf,
    sample_gtr1,
    schlick_weight,
    smith_g,
    smith_g_aniso,
)


class Material(NamedTuple):
    """Runtime material record (``common.hlsl:106-135``), batched ``(B, ...)``."""

    base_color: jnp.ndarray        # (B,3)
    opacity: jnp.ndarray           # (B,)
    emission: jnp.ndarray          # (B,3)
    alpha_mode: jnp.ndarray        # (B,) int32
    alpha_cutoff: jnp.ndarray      # (B,)
    anisotropic: jnp.ndarray       # (B,)
    metallic: jnp.ndarray          # (B,)
    roughness: jnp.ndarray         # (B,)
    subsurface: jnp.ndarray        # (B,)
    specular_tint: jnp.ndarray     # (B,)
    sheen: jnp.ndarray             # (B,)
    sheen_tint: jnp.ndarray        # (B,)
    clearcoat: jnp.ndarray         # (B,)
    clearcoat_roughness: jnp.ndarray  # (B,)
    spec_trans: jnp.ndarray        # (B,)
    ior: jnp.ndarray               # (B,)
    ax: jnp.ndarray                # (B,)
    ay: jnp.ndarray                # (B,)
    eta: jnp.ndarray               # (B,)  hemisphere-relative IOR
    occlusion: jnp.ndarray         # (B,)


def make_material(
    base_color=(0.8, 0.8, 0.8),
    opacity=1.0,
    emission=(0.0, 0.0, 0.0),
    alpha_mode=0,
    alpha_cutoff=0.5,
    anisotropic=0.0,
    metallic=0.0,
    roughness=0.5,
    subsurface=0.0,
    specular_tint=0.0,
    sheen=0.0,
    sheen_tint=0.0,
    clearcoat=0.0,
    clearcoat_gloss=0.0,
    spec_trans=None,
    ior=1.5,
    eta=None,
    occlusion=1.0,
    batch_shape=(),
) -> Material:
    """Build a broadcastable Material for tests / procedural scenes.

    Derivations mirror ``material.hlsl:84-137``: roughness floor 1e-3, ior
    clamp [1.001, 2], anisotropic aspect split into ax/ay, specTrans from
    opacity unless given, clearcoatRoughness = lerp(0.1, 0.001, gloss).
    """

    def b(x):
        return jnp.broadcast_to(jnp.asarray(x, dtype=jnp.float32), batch_shape)

    def b3(x):
        return jnp.broadcast_to(jnp.asarray(x, dtype=jnp.float32), batch_shape + (3,))

    roughness = jnp.maximum(jnp.asarray(roughness, jnp.float32), 0.001)
    ior_c = jnp.clip(jnp.asarray(ior, jnp.float32), 1.001, 2.0)
    aniso = jnp.clip(jnp.asarray(anisotropic, jnp.float32), -0.9, 0.9)
    aspect = jnp.sqrt(1.0 - aniso * 0.9)
    ax = jnp.maximum(0.001, roughness / aspect)
    ay = jnp.maximum(0.001, roughness * aspect)
    if spec_trans is None:
        spec_trans = 1.0 - jnp.clip(jnp.asarray(opacity, jnp.float32), 0.0, 1.0)
    if eta is None:
        eta = 1.0 / ior_c
    return Material(
        base_color=b3(base_color),
        opacity=b(opacity),
        emission=b3(emission),
        alpha_mode=jnp.broadcast_to(jnp.asarray(alpha_mode, jnp.int32), batch_shape),
        alpha_cutoff=b(alpha_cutoff),
        anisotropic=b(aniso),
        metallic=b(metallic),
        roughness=b(roughness),
        subsurface=b(subsurface),
        specular_tint=b(specular_tint),
        sheen=b(sheen),
        sheen_tint=b(sheen_tint),
        clearcoat=b(clearcoat),
        clearcoat_roughness=b(0.1 + (0.001 - 0.1) * jnp.asarray(clearcoat_gloss, jnp.float32)),
        spec_trans=b(spec_trans),
        ior=b(ior_c),
        ax=b(ax),
        ay=b(ay),
        eta=b(eta),
        occlusion=b(occlusion),
    )


def _safe_div(a, b, eps=1e-20):
    return a / jnp.where(jnp.abs(b) < eps, jnp.where(b < 0, -eps, eps), b)


def tint_colors(mat: Material, eta: jnp.ndarray):
    """Base-color tint split (``brdf.hlsl:9-23``): returns (F0, Csheen, Cspec0)."""
    lum = luminance(mat.base_color)
    ctint = jnp.where(
        (lum > 0.0)[..., None], mat.base_color / jnp.maximum(lum, 1e-20)[..., None], 1.0
    )
    f0 = ((1.0 - eta) / (1.0 + eta)) ** 2
    cspec0 = f0[..., None] * (
        1.0 + (ctint - 1.0) * mat.specular_tint[..., None]
    )
    csheen = 1.0 + (ctint - 1.0) * mat.sheen_tint[..., None]
    return f0, csheen, cspec0


def eval_diffuse(mat: Material, csheen, v, l, h):
    """Disney diffuse + retro + fake subsurface + sheen (``brdf.hlsl:25-54``)."""
    lz, vz = l[..., 2], v[..., 2]
    l_dot_h = dot(l, h)
    rr = 2.0 * mat.roughness * l_dot_h * l_dot_h
    fl = schlick_weight(lz)
    fv = schlick_weight(vz)
    fretro = rr * (fl + fv + fl * fv * (rr - 1.0))
    fd = (1.0 - 0.5 * fl) * (1.0 - 0.5 * fv)
    fss90 = 0.5 * rr
    fss = (1.0 + (fss90 - 1.0) * fl) * (1.0 + (fss90 - 1.0) * fv)
    ss = 1.25 * (fss * (_safe_div(1.0, lz + vz) - 0.5) + 0.5)
    fh = schlick_weight(l_dot_h)
    fsheen = fh[..., None] * mat.sheen[..., None] * csheen
    pdf = lz * INV_PI
    f = (
        INV_PI
        * mat.base_color
        * ((fd + fretro) + (ss - (fd + fretro)) * mat.subsurface)[..., None]
        + fsheen
    )
    valid = lz > 0.0
    return jnp.where(valid[..., None], f, 0.0), jnp.where(valid, pdf, 0.0)


def eval_microfacet_reflection(mat: Material, v, l, h, f_term):
    """Aniso GGX reflection with VNDF pdf (``brdf.hlsl:56-70``)."""
    lz, vz = l[..., 2], v[..., 2]
    d = gtr2_aniso(h[..., 2], h[..., 0], h[..., 1], mat.ax, mat.ay)
    g1 = smith_g_aniso(jnp.abs(vz), v[..., 0], v[..., 1], mat.ax, mat.ay)
    g2 = g1 * smith_g_aniso(jnp.abs(lz), l[..., 0], l[..., 1], mat.ax, mat.ay)
    pdf = _safe_div(g1 * d, 4.0 * vz)
    f = f_term * _safe_div(d * g2, 4.0 * lz * vz)[..., None]
    valid = lz > 0.0
    return jnp.where(valid[..., None], f, 0.0), jnp.where(valid, pdf, 0.0)


def eval_microfacet_refraction(mat: Material, eta, v, l, h, f_term):
    """Aniso GGX refraction with eta^2 Jacobian (``brdf.hlsl:72-93``)."""
    lz, vz = l[..., 2], v[..., 2]
    l_dot_h = dot(l, h)
    v_dot_h = dot(v, h)
    d = gtr2_aniso(h[..., 2], h[..., 0], h[..., 1], mat.ax, mat.ay)
    g1 = smith_g_aniso(jnp.abs(vz), v[..., 0], v[..., 1], mat.ax, mat.ay)
    g2 = g1 * smith_g_aniso(jnp.abs(lz), l[..., 0], l[..., 1], mat.ax, mat.ay)
    denom = (l_dot_h + v_dot_h * eta) ** 2
    eta2 = eta * eta
    jacobian = _safe_div(jnp.abs(l_dot_h), denom)
    pdf = _safe_div(g1 * jnp.maximum(0.0, v_dot_h) * d * jacobian, vz)
    f = (
        jnp.sqrt(jnp.maximum(mat.base_color, 0.0))
        * (1.0 - f_term)
        * (d * g2 * jnp.abs(v_dot_h) * jacobian * eta2)[..., None]
        * _safe_div(1.0, jnp.abs(lz * vz))[..., None]
    )
    valid = lz < 0.0
    return jnp.where(valid[..., None], f, 0.0), jnp.where(valid, pdf, 0.0)


def eval_clearcoat(mat: Material, v, l, h):
    """GTR1 clearcoat lobe (``brdf.hlsl:95-112``)."""
    lz, vz = l[..., 2], v[..., 2]
    v_dot_h = dot(v, h)
    f = 0.04 + 0.96 * schlick_weight(v_dot_h)
    d = gtr1(h[..., 2], mat.clearcoat_roughness)
    g = smith_g(lz, 0.25) * smith_g(vz, 0.25)
    jacobian = _safe_div(1.0, 4.0 * v_dot_h)
    pdf = d * h[..., 2] * jacobian
    valid = lz > 0.0
    fo = jnp.where(valid[..., None], (f * d * g)[..., None] * jnp.ones((3,), v.dtype), 0.0)
    return fo, jnp.where(valid, pdf, 0.0)


def _lobe_probabilities(mat: Material, v_local):
    """Luminance-weighted lobe CDF (``brdf.hlsl:137-156``)."""
    f0, csheen, cspec0 = tint_colors(mat, mat.eta)
    dielectric_wt = (1.0 - mat.metallic) * (1.0 - mat.spec_trans)
    metal_wt = mat.metallic
    glass_wt = (1.0 - mat.metallic) * mat.spec_trans
    sw = schlick_weight(v_local[..., 2])
    diff_pr = dielectric_wt * luminance(mat.base_color)
    dielectric_pr = dielectric_wt * luminance(
        cspec0 + (1.0 - cspec0) * sw[..., None]
    )
    metal_pr = metal_wt * luminance(
        mat.base_color + (1.0 - mat.base_color) * sw[..., None]
    )
    glass_pr = glass_wt
    clearcoat_pr = 0.25 * mat.clearcoat
    total = diff_pr + dielectric_pr + metal_pr + glass_pr + clearcoat_pr
    inv_total = _safe_div(1.0, total)
    return (
        (diff_pr * inv_total, dielectric_pr * inv_total, metal_pr * inv_total,
         glass_pr * inv_total, clearcoat_pr * inv_total),
        (dielectric_wt, metal_wt, glass_wt),
        (f0, csheen, cspec0),
    )


def _eval_brdf_local(mat: Material, v, l):
    """Core lobe sum in tangent space (``brdf.hlsl:114-225``).

    Returns ``(f, pdf)`` with ``f`` already multiplied by occlusion and
    ``|L.z|`` like the reference (:222-224).
    """
    lz, vz = l[..., 2], v[..., 2]
    # Half vector: reflection vs refraction case (:122-129).
    h = jnp.where((lz > 0.0)[..., None], normalize(l + v), normalize(l + v * mat.eta[..., None]))
    h = jnp.where((h[..., 2] < 0.0)[..., None], -h, h)

    (diff_pr, dielectric_pr, metal_pr, glass_pr, clearcoat_pr), \
        (dielectric_wt, metal_wt, glass_wt), (f0, csheen, cspec0) = \
        _lobe_probabilities(mat, v)

    reflect_side = lz * vz > 0.0
    v_dot_h = jnp.abs(dot(v, h))

    f = jnp.zeros_like(mat.base_color)
    pdf = jnp.zeros_like(lz)

    # Diffuse (:164-168)
    fd, pd = eval_diffuse(mat, csheen, v, l, h)
    gate = (diff_pr > 0.0) & reflect_side
    f = f + jnp.where(gate[..., None], fd * dielectric_wt[..., None], 0.0)
    pdf = pdf + jnp.where(gate, pd * diff_pr, 0.0)

    # Dielectric reflection, Fresnel normalized against F0 (:171-185)
    inv_eta = _safe_div(1.0, mat.ior)
    fres = _safe_div(dielectric_fresnel(v_dot_h, inv_eta) - f0, 1.0 - f0)
    fres = jnp.where((f0 != 1.0) & (mat.ior != 0.0), fres, 0.0)
    f_term = cspec0 + (1.0 - cspec0) * fres[..., None]
    fr, pr = eval_microfacet_reflection(mat, v, l, h, f_term)
    gate = (dielectric_pr > 0.0) & reflect_side
    f = f + jnp.where(gate[..., None], fr * dielectric_wt[..., None], 0.0)
    pdf = pdf + jnp.where(gate, pr * dielectric_pr, 0.0)

    # Metallic reflection, Schlick to white (:188-195)
    f_metal = mat.base_color + (1.0 - mat.base_color) * schlick_weight(v_dot_h)[..., None]
    fm, pm = eval_microfacet_reflection(mat, v, l, h, f_metal)
    gate = (metal_pr > 0.0) & reflect_side
    f = f + jnp.where(gate[..., None], fm * metal_wt[..., None], 0.0)
    pdf = pdf + jnp.where(gate, pm * metal_pr, 0.0)

    # Glass reflect/refract, achromatic Fresnel split (:198-213)
    f_glass = dielectric_fresnel(v_dot_h, mat.eta)
    fgr, pgr = eval_microfacet_reflection(mat, v, l, h, f_glass[..., None])
    fgt, pgt = eval_microfacet_refraction(mat, mat.eta, v, l, h, f_glass[..., None])
    gate = glass_pr > 0.0
    f = f + jnp.where(
        gate[..., None],
        jnp.where(reflect_side[..., None], fgr, fgt) * glass_wt[..., None],
        0.0,
    )
    pdf = pdf + jnp.where(
        gate,
        jnp.where(reflect_side, pgr * glass_pr * f_glass, pgt * glass_pr * (1.0 - f_glass)),
        0.0,
    )

    # Clearcoat (:216-220)
    fc, pc = eval_clearcoat(mat, v, l, h)
    gate = (clearcoat_pr > 0.0) & reflect_side
    f = f + jnp.where(gate[..., None], fc * (0.25 * mat.clearcoat)[..., None], 0.0)
    pdf = pdf + jnp.where(gate, pc * clearcoat_pr, 0.0)

    f = f * mat.occlusion[..., None]
    return f * jnp.abs(lz)[..., None], pdf


def eval_brdf(mat: Material, v_world, n, l_world):
    """Evaluate f and pdf for world-space V/N/L (``brdf.hlsl:227-238``)."""
    onb = build_onb(n)
    v = to_local(onb, v_world)
    l = to_local(onb, l_world)
    return _eval_brdf_local(mat, v, l)


def sample_brdf(mat: Material, v_world, n, state):
    """Importance-sample a scatter direction (``brdf.hlsl:240-340``).

    Draw order matches the reference exactly (r1, r2, r3) so renders are
    stream-compatible.  Returns ``(f, l_world, pdf, new_state)``.
    """
    (r1, r2, r3), state = urng.random_floats(state, 3)

    onb = build_onb(n)
    v = to_local(onb, v_world)

    (diff_pr, dielectric_pr, metal_pr, glass_pr, _cc_pr), _, _ = \
        _lobe_probabilities(mat, v)
    cdf0 = diff_pr
    cdf1 = cdf0 + dielectric_pr
    cdf2 = cdf1 + metal_pr
    cdf3 = cdf2 + glass_pr

    # Candidate directions for every lobe (computed for all lanes; selected
    # by the CDF masks — the batched analogue of the scalar if/else chain).
    l_diff = cosine_sample_hemisphere(r1, r2)

    h_ggx = sample_ggx_vndf(v, mat.ax, mat.ay, r1, r2)
    h_ggx = jnp.where((h_ggx[..., 2] < 0.0)[..., None], -h_ggx, h_ggx)
    l_spec = normalize(reflect(-v, h_ggx))

    f_glass = dielectric_fresnel(jnp.abs(dot(v, h_ggx)), mat.eta)
    r3_rescaled = _safe_div(r3 - cdf2, cdf3 - cdf2)
    l_refr = normalize(refract(-v, h_ggx, mat.eta))
    l_glass = jnp.where((r3_rescaled < f_glass)[..., None], l_spec, l_refr)

    h_cc = sample_gtr1(mat.clearcoat_roughness, r1, r2)
    h_cc = jnp.where((h_cc[..., 2] < 0.0)[..., None], -h_cc, h_cc)
    l_cc = normalize(reflect(-v, h_cc))

    l = jnp.where(
        (r3 < cdf0)[..., None],
        l_diff,
        jnp.where(
            (r3 < cdf2)[..., None],
            l_spec,
            jnp.where((r3 < cdf3)[..., None], l_glass, l_cc),
        ),
    )

    f, pdf = _eval_brdf_local(mat, v, l)
    return f, to_world(onb, l), pdf, state
