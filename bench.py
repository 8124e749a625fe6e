#!/usr/bin/env python
"""Headline benchmark: Mrays/s on the north-star workload (~1M-triangle
scene, 1080p, fused wavefront integrator, HDRI env NEE, 5 bounces).

Runs on a GPU only: with any other default backend it exits non-zero and
names the platform it found.  Prints ONE JSON line on stdout with the
headline (best timed pass), every pass's rate, and the device it ran on
(JAX's platform / device_kind / device count, plus nvidia-smi's name and
power limit).

Flags (env vars):
  BENCH_SMALL=1   quick mode (64K tris, 512x512) for smoke testing
  BENCH_PASSES=N  timed passes; the BEST pass is the headline (default 3)
  BENCH_POOL=N    wavefront pool size (default 3<<15 = 96k)
  BENCH_SPP=N     samples per pixel per pass (default 64)
  BENCH_TE=N      arrivals per transition (default 8)
  BENCH_CORNELL=1 report BASELINE.md's third metric instead:
                  time-to-1024spp on the 256x256 Cornell box
"""

import json
import os
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_workload(width=1920, height=1080, target_tris=1_000_000, spp=64,
                  pool=3 << 15, te=8, traversal="wide16", attr_compact=2,
                  **config_kw):
    """The bench scene, camera and config: ``(scene, config, params)``.

    ``models.benchmark.million_triangle_scene`` (generated from a fixed
    seed, procedural HDRI), 5 bounces, HDRI environment NEE, Russian
    roulette, the fused integrator over wide16 rows."""
    from unity_webgpu_pathtracer_tpu.config import SKY_MODE_ENVIRONMENT, RenderConfig
    from unity_webgpu_pathtracer_tpu.models.benchmark import million_triangle_scene
    from unity_webgpu_pathtracer_tpu.render.camera import make_camera_params

    scene, cam = million_triangle_scene(target_tris)
    config = RenderConfig(
        width=width, height=height, samples_per_pass=spp, max_bounces=5,
        traversal=traversal, sky_mode=SKY_MODE_ENVIRONMENT,
        has_environment_texture=True, use_russian_roulette=True,
        integrator="fused", pool_size=pool, bvh_octants=1,
        transition_every=te, attr_compact=attr_compact, **config_kw,
    )
    params = make_camera_params(width=width, height=height, **cam,
                                environment_intensity=np.float32(1.0))
    return scene, config, params


def device_fields(devices):
    """What the numbers were measured on: JAX's platform / device_kind /
    device count, and nvidia-smi's name and power limit."""
    from unity_webgpu_pathtracer_tpu.utils.device import (
        device_info,
        gpu_name_and_power_limit,
    )

    info = device_info(devices)
    return {"platform": info["platform"], "device_kind": info["kind"],
            "device_count": info["count"],
            "nvidia_smi": gpu_name_and_power_limit()}


def bench_cornell(devices):
    """BASELINE.md metric 3: time-to-1024 spp on the 256^2 Cornell box.

    The reference renders Cornell at samplesPerPass=1 progressive; here
    one jitted fused pass does 64 spp and 16 passes reach 1024.
    """
    import jax

    from unity_webgpu_pathtracer_tpu.config import RenderConfig
    from unity_webgpu_pathtracer_tpu.models.cornell import cornell_box
    from unity_webgpu_pathtracer_tpu.render.camera import make_camera_params
    from unity_webgpu_pathtracer_tpu.render.fused import fused_pass_with_stats

    scene, cam = cornell_box()
    size = int(os.environ.get("BENCH_CORNELL_SIZE", 256))
    spp_pass = int(os.environ.get("BENCH_CORNELL_SPP", 64))
    target = int(os.environ.get("BENCH_CORNELL_TARGET", 1024))
    config = RenderConfig(
        width=size, height=size, samples_per_pass=spp_pass, max_bounces=4,
        sky_mode=2, traversal="wide16", integrator="fused",
        pool_size=1 << 17,
    )
    sd = scene.build(config.traversal)
    params = make_camera_params(width=size, height=size, **cam)
    step = jax.jit(fused_pass_with_stats, static_argnums=(1,),
                   static_argnames=("pool_size",))
    film, *_ = step(sd, config, params, 0, pool_size=config.pool_size)
    film.block_until_ready()  # compile + settle
    t0 = time.perf_counter()
    total = None
    for i in range(target // spp_pass):
        film, _occ, _rays, _arr = step(sd, config, params, i * spp_pass,
                                       pool_size=config.pool_size)
        film_np = np.asarray(film)  # host read inside the timed region
        total = film_np if total is None else total + film_np
    dt = time.perf_counter() - t0
    log(f"cornell {size}^2: {target} spp in {dt:.2f}s, film mean "
        f"{total.mean() / target:.4f}")
    print(json.dumps({
        "metric": f"time-to-{target}spp (Cornell box {size}x{size}, "
                  "fused wavefront)",
        "value": dt,
        "unit": "s",
        **device_fields(devices),
    }))


def main():
    from unity_webgpu_pathtracer_tpu.compile_cache import enable_compile_cache
    from unity_webgpu_pathtracer_tpu.utils.device import (
        NoGPUError,
        peak_bytes_in_use,
        require_gpu,
    )

    enable_compile_cache()
    try:
        devices = require_gpu()
    except NoGPUError as e:
        log(f"bench: {e}; refusing to time anything else")
        return 2
    log(f"devices: {devices}")

    import jax

    from unity_webgpu_pathtracer_tpu.render.fused import fused_pass_with_stats

    if os.environ.get("BENCH_CORNELL") == "1":
        bench_cornell(devices)
        return 0

    small = os.environ.get("BENCH_SMALL") == "1"
    pool = int(os.environ.get("BENCH_POOL", 3 << 15))
    spp = int(os.environ.get("BENCH_SPP", 64))
    te = int(os.environ.get("BENCH_TE", 8))
    # Attr table layout (config.attr_compact): 2 = f16 rows (32 B/tri),
    # 3 = oct-normal rows (16 B/tri; valid here — the bench scene is
    # untextured).
    attr_mode = int(os.environ.get("BENCH_ATTR", 2))
    trav = os.environ.get("BENCH_TRAV", "wide16")
    # Record film (append + end-of-pass sort resolve) A/B toggle; the
    # config default governs when unset.
    film_kw = {}
    record = os.environ.get("BENCH_RECORD")
    if record is not None:
        film_kw["use_record_film"] = record == "1"
        film_kw["film_k_shift"] = int(os.environ.get("BENCH_KSHIFT", 0))
    width, height = (512, 512) if small else (1920, 1080)
    target_tris = 64_000 if small else 1_000_000
    if small:
        pool = min(pool, 1 << 17)

    t0 = time.perf_counter()
    scene, config, params = make_workload(
        width, height, target_tris, spp, pool, te, trav, attr_mode,
        **film_kw)
    scene_data = scene.build(config.traversal, octants=config.bvh_octants)
    build_s = time.perf_counter() - t0
    from unity_webgpu_pathtracer_tpu.accel.wide16 import CACHE_STATS

    bvh_cache = ("hit" if CACHE_STATS["hit"] > 0 and CACHE_STATS["miss"] == 0
                 else "miss" if CACHE_STATS["miss"] > 0 else "off")
    # Triangle accounting: `tris_unique` is the flattened INPUT triangle
    # count; `refs` is the post-SBVH reference count (spatial splits
    # duplicate references).  Mrays/s is rays retired, independent of
    # either.
    tris_unique = int(scene.flatten().count)
    refs = int(scene_data.tris.shape[0])
    import hashlib

    scene_hash = hashlib.sha1(
        np.asarray(scene_data.attr_uvs[:1024]).tobytes()
        + np.asarray(scene_data.attr_normals[:1024]).tobytes()
        + str(tris_unique).encode()
    ).hexdigest()[:12]
    nodes = {
        "wide8": scene_data.wide8_nodes,
        "wide16": scene_data.wide16_nodes,
    }.get(trav, scene_data.wide_nodes)
    log(f"scene: {tris_unique:,} unique tris ({refs:,} refs), "
        f"{int(nodes.shape[-2]):,} {trav} rows ({nodes.nbytes / 1e6:.0f} MB), "
        f"build {build_s:.1f}s, hash {scene_hash}")

    step = jax.jit(fused_pass_with_stats, static_argnums=(1,),
                   static_argnames=("pool_size",))

    t0 = time.perf_counter()
    film, occ, rays, arrivals = step(scene_data, config, params, 0,
                                     pool_size=pool)
    film.block_until_ready()
    compile_s = time.perf_counter() - t0
    log(f"compile+first pass: {compile_s:.1f}s")

    # Timed passes: each pass is timed on its own, ending in a host read
    # of the film; the BEST pass is the headline and the full per-pass
    # list shows the spread.
    n_passes = int(os.environ.get("BENCH_PASSES", 3))
    pass_mrays = []
    pass_dt = []
    for i in range(n_passes):
        t0 = time.perf_counter()
        film, occ, rays, arrivals = step(scene_data, config, params, i + 1,
                                         pool_size=pool)
        film_np = np.asarray(film)
        pass_dt.append(time.perf_counter() - t0)
        pass_mrays.append(int(rays) / pass_dt[-1] / 1e6)

    best = int(np.argmax(pass_mrays))
    mrays = pass_mrays[best]
    spp_sec = config.samples_per_pass / pass_dt[best]
    log(f"occupancy {float(occ):.3f}, passes {pass_mrays} -> best "
        f"{mrays:.2f} Mrays/s, {spp_sec:.3f} {height}p-spp/s, film mean "
        f"{film_np.mean():.4f}")

    print(json.dumps({
        "metric": ("Mrays/sec (64K-tri scene, 512x512, fused wavefront, "
                   "5 bounces, BENCH_SMALL)" if small else
                   "Mrays/sec (1M-tri scene, 1080p, fused wavefront, "
                   "5 bounces)"),
        "value": mrays,
        "unit": "Mrays/s",
        **device_fields(devices),
        "tris_unique": tris_unique,
        "refs": refs,
        "scene_hash": scene_hash,
        "compile_s": compile_s,
        "scene_build_s": build_s,
        "bvh_cache": bvh_cache,
        "occupancy": float(occ),
        "spp_per_s": spp_sec,
        "pass_s": pass_dt,
        "pass_mrays": pass_mrays,
        "peak_bytes_in_use": peak_bytes_in_use(devices[0]),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
