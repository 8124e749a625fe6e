"""Fast preview renderer (one dispatch, no accumulation).

The reference ships a raster Disney-BRDF preview shader so materials can be
inspected cheaply with the same property names and lobes
(``Assets/Resources/Shaders/PathTracer.shader:146-216``, SURVEY.md L4).
The batched analogue: a single primary-visibility pass shaded with the SAME
``eval_brdf`` the path tracer uses (full 5-lobe Disney), lit by one
directional key light plus a hemispheric ambient — lobe-equivalent to the
reference's ForwardBase pass, at a tiny fraction of a path-traced pass.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from unity_webgpu_pathtracer_tpu.config import RenderConfig, RenderParams
from unity_webgpu_pathtracer_tpu.ops import get_intersectors
from unity_webgpu_pathtracer_tpu.render import camera as ucamera
from unity_webgpu_pathtracer_tpu.render.hitinfo import shade_prep
from unity_webgpu_pathtracer_tpu.render.sky import sample_sky_radiance
from unity_webgpu_pathtracer_tpu.scene.material import derive_material
from unity_webgpu_pathtracer_tpu.utils import rng as urng
from unity_webgpu_pathtracer_tpu.utils.math import dot


@functools.partial(jax.jit, static_argnums=(1,))
def preview(scene, config: RenderConfig, params: RenderParams):
    """Render a (H, W, 3) preview image (linear radiance-ish)."""
    pixels = jnp.arange(config.pixel_count(), dtype=jnp.uint32)
    state = urng.seed(pixels, jnp.uint32(0), params.seed_root)
    coords, state = ucamera.jittered_pixel_coords(pixels, config, state)
    o, d, state = ucamera.get_screen_ray(coords, config, params, state)

    closest_fn, _ = get_intersectors(config)
    t, bary, slot, inst = closest_fn(scene, o, d)
    hit = shade_prep(scene, o, d, t, bary, slot, inst)

    mdata = scene.materials[jnp.maximum(hit.material, 0)]
    mat = derive_material(mdata, hit.uv, d, hit.normal,
                          scene.texture_data, config.has_textures)

    # Key light: the reference's ForwardBase directional pass, evaluated
    # with the path tracer's own Disney BSDF (same lobes, same weights).
    from unity_webgpu_pathtracer_tpu.render.bsdf import eval_brdf
    from unity_webgpu_pathtracer_tpu.utils.math import normalize

    key_dir = normalize(jnp.asarray([0.4, 0.8, 0.45], jnp.float32))
    key_l = jnp.broadcast_to(key_dir, d.shape)
    f, _pdf = eval_brdf(mat, -d, hit.ffnormal, key_l)
    n_dot_l = jnp.maximum(dot(hit.ffnormal, key_l), 0.0)
    key = f * (3.0 * n_dot_l)[:, None]

    # Hemispheric ambient + emission (PathTracer.shader ambient term).
    n_dot_v = jnp.abs(dot(hit.ffnormal, -d))
    up = jnp.clip(0.5 + 0.5 * hit.ffnormal[:, 1], 0.0, 1.0)
    ambient = mat.base_color * (0.15 + 0.2 * up + 0.1 * n_dot_v)[:, None]
    shaded = key + ambient + mat.emission

    sky, _ = sample_sky_radiance(config, params, scene.env, d,
                                 jnp.zeros_like(slot))
    img = jnp.where(hit.valid[:, None], shaded, sky)
    return img.reshape(config.height, config.width, 3)
