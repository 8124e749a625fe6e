#!/usr/bin/env python
"""GPU smoke test of the fused wavefront path tracer.

    python chip_smoke.py               # phases 1-6 on one GPU
    python chip_smoke.py --four-gpus   # phase 7 alone, on four GPUs

One process runs every phase on the card, in order, and prints each
phase's wall time.  A failing phase stops the run with a non-zero exit.

1. device: JAX devices, version, XLA_FLAGS, compile cache, nvidia-smi;
2. XLA only: the fused pass of three configs lowers to plain XLA — no
   custom call (Mosaic or otherwise) and no Pallas call, which off its
   own backend could only run in interpret mode;
3. golden gates: the nine golden scenes rendered on the card against the
   CPU fixtures (tests/golden_common.py);
4. traversal: 1M-triangle primary rays traced on the GPU and on the CPU
   of the same process agree; prestep on/off give bitwise-equal hits;
5. precision: camera rays, ACES and ``gather_small`` against float64
   NumPy;
6. main path: ``Renderer`` on the bench workload (1M triangles, 1080p,
   64 spp per pass), then the CLI renders a builtin scene to PNG, then a
   profiler trace of one bench pass is reduced to device time per layer
   (``<out-dir>/trace``);
7. four GPUs (``--four-gpus`` only): the 4K film tiled over four cards
   against the single-card pass.

The last stdout line is ``{"ok": true, "device": {...}}``.  Without a GPU
the script exits non-zero, names the platform it found and prints no
result.  Every phase is a plain function taking its sizes, so the CPU
tests (tests/test_chip_smoke.py) run each one at a tiny size.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import re
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import bench  # noqa: E402
from unity_webgpu_pathtracer_tpu.compile_cache import enable_compile_cache  # noqa: E402
from unity_webgpu_pathtracer_tpu.ops import traverse_wide16 as tw16  # noqa: E402
from unity_webgpu_pathtracer_tpu.render import camera as ucamera  # noqa: E402
from unity_webgpu_pathtracer_tpu.render.fused import fused_pass_with_stats  # noqa: E402
from unity_webgpu_pathtracer_tpu.utils.device import (  # noqa: E402
    NoGPUError,
    device_info,
    gpu_name_and_power_limit,
    peak_bytes_in_use,
    require_gpu,
)
from unity_webgpu_pathtracer_tpu.utils.math import FAR_PLANE, safe_rcp  # noqa: E402

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet peak
# Custom calls the fused pass may contain: none — every kernel is XLA's.
ALLOWED_CUSTOM_CALLS = frozenset()


def say(*a):
    print(*a, flush=True)


def run_phase(label, fn, *args, **kwargs):
    say(f"== phase {label}")
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    say(f"== phase {label}: {time.perf_counter() - t0:.2f} s")
    return out


def fused_step():
    return jax.jit(fused_pass_with_stats, static_argnums=(1,),
                   static_argnames=("pool_size",))


# -- phase 1 ---------------------------------------------------------------

def phase_device(devices):
    """Print what this process runs on; returns nvidia-smi's line."""
    say(f"devices: {devices}")
    say(f"device_kind: {devices[0].device_kind}")
    say(f"jax {jax.__version__}")
    say(f"XLA_FLAGS: {os.environ.get('XLA_FLAGS', '')!r}")
    say(f"compile cache: {jax.config.jax_compilation_cache_dir or 'off'}")
    card = gpu_name_and_power_limit()
    say("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader:")
    say(card)
    return card


# -- phase 2 ---------------------------------------------------------------

def example_workload(name, size=64, spp=4, pool=4096, scene_fn=None):
    """A builtin example scene on the production path (fused + wide16),
    configured the way the CLI configures it: ``(scene_data, config,
    params)``."""
    from unity_webgpu_pathtracer_tpu.config import RenderConfig
    from unity_webgpu_pathtracer_tpu.models.examples import EXAMPLES

    scene, cam, overrides = (scene_fn or EXAMPLES[name])()
    overrides = dict(overrides, traversal="wide16")
    overrides.setdefault("has_lights", bool(scene.lights))
    overrides.setdefault("has_textures", bool(scene.textures))
    config = RenderConfig(width=size, height=size, samples_per_pass=spp,
                          integrator="fused", pool_size=pool,
                          transition_every=8, **overrides)
    params = ucamera.make_camera_params(width=size, height=size, **cam)
    return scene.build(config.traversal), config, params


def textured_lit_scene():
    """The builtin textured scene plus a point and a rect light."""
    from unity_webgpu_pathtracer_tpu.config import (
        LIGHT_TYPE_POINT,
        LIGHT_TYPE_RECTANGLE,
    )
    from unity_webgpu_pathtracer_tpu.models.examples import texture_scene
    from unity_webgpu_pathtracer_tpu.scene.lights import LightDesc

    scene, cam, overrides = texture_scene()
    scene.add_light(LightDesc(type=LIGHT_TYPE_POINT, position=(-2, 2, 1),
                              color=(1.0, 0.8, 0.6), intensity=6.0, range=20))
    scene.add_light(LightDesc(type=LIGHT_TYPE_RECTANGLE, position=(0, 3, -2),
                              right=(1, 0, 0), up=(0, 0.2, 1), size=(2, 1),
                              color=(1, 1, 1), intensity=8.0, range=30))
    return scene, cam, dict(overrides, has_lights=True)


def custom_call_targets(hlo):
    return sorted(set(re.findall(r"custom_call @([\w.\-]+)", hlo))
                  | set(re.findall(r'custom_call_target="([^"]+)"', hlo)))


def non_xla_findings(jaxpr_text, hlo):
    """What in a lowered program is not XLA's own code: custom calls
    outside :data:`ALLOWED_CUSTOM_CALLS` (a Mosaic kernel lowers to one),
    or a Pallas call (off its backend it would run interpreted)."""
    found = [f"custom call {t}" for t in custom_call_targets(hlo)
             if t not in ALLOWED_CUSTOM_CALLS]
    if "pallas_call" in jaxpr_text:
        found.append("pallas_call in the jaxpr")
    return found


def check_xla_only(scene_data, config, params):
    """Lower the fused pass and fail on :func:`non_xla_findings`."""
    traced = fused_step().trace(scene_data, config, params, 0,
                                pool_size=config.pool_size or None)
    findings = non_xla_findings(str(traced.jaxpr), traced.lower().as_text())
    assert not findings, findings


def phase_xla_only(workloads):
    """``workloads``: {label: (scene_data, config, params)}."""
    for label, (sd, config, params) in workloads.items():
        check_xla_only(sd, config, params)
        say(f"{label}: plain XLA (no custom call, no Pallas call)")


# -- phase 3 ---------------------------------------------------------------

def phase_golden(names):
    """Calibrated golden gates (per-pixel z-test + global mean) on the
    scenes ``names``, rendered on the default device."""
    from tests.golden_common import (
        N_TEST_PASSES,
        TEST_SEED_BASE,
        compare_to_golden,
        render_pass_means,
        seed_roots,
    )

    results = {}
    for name in names:
        passes = render_pass_means(name, seed_roots(TEST_SEED_BASE,
                                                    N_TEST_PASSES))
        ok, stats = compare_to_golden(passes, name)
        say(f"golden {name}: {'PASS' if ok else 'FAIL'} {stats}")
        assert ok, f"golden gate failed on {name}: {stats}"
        results[name] = stats
    return results


# -- phase 4 ---------------------------------------------------------------

def primary_rays(config, params, nx, ny):
    """Pinhole rays through an nx x ny grid of pixel centers spread over
    the config's film: host ``(o, d)`` float32 arrays."""
    xs = (np.arange(nx) + 0.5) * (config.width / nx)
    ys = (np.arange(ny) + 0.5) * (config.height / ny)
    coords = np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2)
    o, d, _ = ucamera.get_screen_ray(
        jnp.asarray(coords, jnp.float32), config, params,
        jnp.zeros(coords.shape[0], jnp.uint32))
    return np.asarray(o), np.asarray(d)


@functools.partial(jax.jit, static_argnames=("depth", "has_instances",
                                             "prestep"))
def trace_closest(nodes, top, o, d, depth, has_instances, prestep):
    """Closest hits ``(t, tri)`` by ``arrival_step16`` to completion;
    with ``prestep`` the first levels run gather-free (``prestep16``)."""
    inv = safe_rcp(d)
    s = tw16.init_state16(o.shape[0], jnp.float32(FAR_PLANE), depth=depth)
    if prestep:
        s = tw16.prestep16(nodes, top, o, d, inv, s,
                           jnp.ones(o.shape[0], bool))
    s = jax.lax.while_loop(
        lambda s: jnp.any(s.ptr >= 0),
        lambda s: tw16.arrival_step16(nodes, o, d, inv, s, None,
                                      has_instances=has_instances), s)
    return s.t, s.tri


def _trace_on(device, scene_data, o, d, prestep=False):
    put = functools.partial(jax.device_put, device=device)
    t, tri = trace_closest(
        put(scene_data.wide16_nodes), put(scene_data.wide16_top), put(o),
        put(d), depth=int(scene_data.stack_levels.shape[0]),
        has_instances=bool(scene_data.inst_w2l.shape[0] > 0),
        prestep=prestep)
    return np.asarray(t), np.asarray(tri)


def phase_traversal(scene_data, config, params, grid=(240, 135),
                    pool_grid=(384, 256), device=None):
    """GPU (default device) against CPU hits on a grid of primary rays,
    then prestep on/off at pool size ``pool_grid[0] * pool_grid[1]``."""
    dev = device or jax.devices()[0]
    cpu = jax.devices("cpu")[0]
    o, d = primary_rays(config, params, *grid)
    t_g, tri_g = _trace_on(dev, scene_data, o, d)
    t_c, tri_c = _trace_on(cpu, scene_data, o, d)
    miss_g, miss_c = tri_g < 0, tri_c < 0
    assert np.array_equal(miss_g, miss_c), (
        f"{int((miss_g != miss_c).sum())} rays hit on one device only")
    hit = ~miss_c
    # A spatial-split BVH references one triangle from several leaves, and
    # each reference has its own attribute row: two rows name the same
    # triangle when their triangle records are identical.
    recs = np.asarray(scene_data.tris)
    g, c = tri_g[hit], tri_c[hit]
    same = (g == c) | (recs[g] == recs[c]).all(axis=1)
    agree = float(same.mean()) if hit.any() else 1.0
    rel = np.abs(t_g[hit] - t_c[hit]) / np.maximum(np.abs(t_c[hit]), 1e-30)
    t_rel = float(rel[same].max()) if same.any() else 0.0
    other = f"; where they differ, t rel diff <= {rel[~same].max():.3g}" \
        if (~same).any() else ""
    say(f"traversal {dev.platform} vs cpu: {o.shape[0]} rays, "
        f"{int(hit.sum())} hits, misses agree exactly, hit triangles agree "
        f"{agree:.6f} ({int((~same).sum())} differ{other}), max t rel diff "
        f"{t_rel:.3g}")
    assert agree >= 0.9999, f"hit ids agree on only {agree:.6f}"
    assert t_rel <= 1e-5, f"t differs by {t_rel:.3g} relative"

    o2, d2 = primary_rays(config, params, *pool_grid)
    t0, tri0 = _trace_on(dev, scene_data, o2, d2, prestep=False)
    t1, tri1 = _trace_on(dev, scene_data, o2, d2, prestep=True)
    assert np.array_equal(tri0, tri1), "prestep changed hit triangles"
    assert np.array_equal(t0.view(np.uint32), t1.view(np.uint32)), (
        "prestep changed hit distances")
    say(f"prestep on/off on {dev.platform}: {o2.shape[0]} lanes, "
        f"{int((tri0 >= 0).sum())} hits, bitwise equal")
    return {"agree": agree, "t_rel": t_rel}


# -- phase 5 ---------------------------------------------------------------

def camera_rays_f64(config, params, coords):
    """Float64 NumPy reference of ``get_screen_ray``'s pinhole path."""
    c2w = np.asarray(params.cam_to_world, np.float64)
    ip = np.asarray(params.cam_inv_proj, np.float64)
    uv = coords.astype(np.float64) / np.array([config.width, config.height]) \
        * 2.0 - 1.0
    dir_cam = uv[:, 0:1] * ip[:3, 0] + uv[:, 1:2] * ip[:3, 1] + ip[:3, 3]
    d = dir_cam @ c2w[:3, :3].T
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def phase_precision(width=1920, height=1080, rows=64, lanes=1 << 17):
    """Full-f32 matmuls and exact small-table gathers on the device."""
    from unity_webgpu_pathtracer_tpu.config import RenderConfig
    from unity_webgpu_pathtracer_tpu.post.tonemap import aces
    from unity_webgpu_pathtracer_tpu.utils.math import gather_small

    config = RenderConfig(width=width, height=height)
    params = ucamera.make_camera_params(
        eye=(1.3, 2.1, 7.7), target=(0.2, 0.4, -0.3), fov_y_deg=55.0,
        width=width, height=height)
    ys, xs = np.divmod(np.arange(width * height), width)
    coords = np.stack([xs + 0.5, ys + 0.5], -1)
    _, d, _ = jax.jit(ucamera.get_screen_ray, static_argnums=(1,))(
        jnp.asarray(coords, jnp.float32), config, params,
        jnp.zeros(coords.shape[0], jnp.uint32))
    ray_err = float(np.abs(np.asarray(d, np.float64)
                           - camera_rays_f64(config, params, coords)).max())
    say(f"camera rays {width}x{height}: max abs error {ray_err:.3g} "
        "vs float64")
    assert ray_err <= 1e-6, ray_err

    rng = np.random.default_rng(5)
    color = rng.uniform(0.0, 8.0, (lanes, 3)).astype(np.float32)
    got = np.asarray(jax.jit(aces)(jnp.asarray(color)), np.float64)
    ref = aces_f64(color)
    aces_err = float((np.abs(got - ref) / np.maximum(np.abs(ref), 1e-3)).max())
    say(f"ACES {lanes} colors: max rel error {aces_err:.3g} vs float64")
    assert aces_err <= 1e-5, aces_err

    table = rng.normal(size=(rows, 22)).astype(np.float32)
    itable = rng.integers(-1000, 1000, (rows, 5)).astype(np.int32)
    idx = rng.integers(0, rows, lanes).astype(np.int32)
    gs = jax.jit(gather_small)
    g = np.asarray(gs(jnp.asarray(table), jnp.asarray(idx)))
    gi = np.asarray(gs(jnp.asarray(itable), jnp.asarray(idx)))
    assert np.array_equal(g.view(np.uint32), table[idx].view(np.uint32)), \
        "gather_small is not exact on f32 rows"
    assert np.array_equal(gi, itable[idx]), "gather_small is not exact on ints"
    say(f"gather_small {lanes} lanes x {rows} rows: bit-exact")
    return {"ray_err": ray_err, "aces_err": aces_err}


def aces_f64(color):
    from unity_webgpu_pathtracer_tpu.post.tonemap import _ACES_IN, _ACES_OUT

    c = color.astype(np.float64) @ np.asarray(_ACES_IN, np.float64).T
    a = c * (c + 0.0245786) - 0.000090537
    b = c * (0.983729 * c + 0.4329510) + 0.238081
    return (a / b) @ np.asarray(_ACES_OUT, np.float64).T


# -- phase 6 ---------------------------------------------------------------

def phase_main(scene_data, config, params, card, out_dir, passes=3,
               build_s=None, cli_size=512, cli_spp=64):
    """``Renderer.render`` on the bench workload (a compile pass plus
    ``passes`` timed passes), then the CLI renders a builtin to PNG."""
    from unity_webgpu_pathtracer_tpu import cli
    from unity_webgpu_pathtracer_tpu.api import Renderer
    from unity_webgpu_pathtracer_tpu.utils.image import read_png

    tag = f"[{card}]"
    if build_s is not None:
        say(f"{tag} scene build: {build_s:.2f} s")
    r = Renderer(scene_data, config, params)
    t0 = time.perf_counter()
    r.render(1)
    compile_s = time.perf_counter() - t0
    say(f"{tag} compile + first pass: {compile_s:.2f} s")
    pass_s, pass_mrays = [], []
    for i in range(passes):
        t0 = time.perf_counter()
        r.render(1)
        pass_s.append(time.perf_counter() - t0)
        stats = r.stats()
        pass_mrays.append(stats["rays"] / pass_s[-1] / 1e6)
        say(f"{tag} pass {i + 1}: {pass_s[-1]:.3f} s, "
            f"{pass_mrays[-1]:.2f} Mrays/s ({stats['rays']} rays), "
            f"occupancy {stats['occupancy']:.4f}")
    peak = peak_bytes_in_use(jax.devices()[0])
    say(f"{tag} peak_bytes_in_use: {peak}")
    film = r.radiance()
    assert np.isfinite(film).all(), "non-finite film"
    assert film.mean() > 0, "black film"
    say(f"{tag} film {film.shape} mean {film.mean():.5f} after "
        f"{r.sample_count} spp")

    os.makedirs(out_dir, exist_ok=True)
    png = os.path.join(out_dir, "sponza_like.png")
    t0 = time.perf_counter()
    cli.main(["render", "builtin:sponza_like", "--size", str(cli_size),
              "--spp", str(cli_spp), "--out", png])
    img = read_png(png)
    say(f"{tag} cli render {cli_size}^2 {cli_spp} spp: "
        f"{time.perf_counter() - t0:.2f} s, png mean {img.mean():.2f}")
    assert img.shape[:2] == (cli_size, cli_size) and img.max() > 0, \
        "black PNG"
    return {"compile_s": compile_s, "pass_s": pass_s,
            "pass_mrays": pass_mrays, "occupancy": stats["occupancy"],
            "peak_bytes_in_use": peak}


def arrival_bytes_per_lane(stack_levels: int) -> int:
    """Device-memory bytes one live lane moves in one arrival (no
    instances): the gathered 384-byte node row, the lane state read
    (ptr/pend/sp/t/u/v/tri, found, both stack planes, ray o/d/inv) and the
    state written back (the same minus the ray)."""
    stacks = 2 * 4 * stack_levels
    read = 7 * 4 + 1 + stacks + 9 * 4
    write = 7 * 4 + 1 + stacks
    return 384 + read + write


def phase_layer_trace(scene_data, config, params, card, trace_dir, spp=2):
    """Device time per layer from a ``jax.profiler`` trace of one fused
    pass of the bench workload at ``spp`` samples per pixel (the pool,
    cadence and per-iteration work are those of the full pass)."""
    from unity_webgpu_pathtracer_tpu.utils.profiling import (
        device_kernel_events,
        hlo_layers,
        layer_times,
        loop_iterations,
    )

    cfg = dataclasses.replace(config, samples_per_pass=spp)
    step = fused_step()
    args = (scene_data, cfg, params, 1)
    jax.block_until_ready(step(*args, pool_size=cfg.pool_size))
    with jax.profiler.trace(trace_dir):
        film, occ, rays, arrivals = step(*args, pool_size=cfg.pool_size)
        jax.block_until_ready(film)
    hlo = step.lower(*args, pool_size=cfg.pool_size).compile().as_text()
    layer_of = hlo_layers(hlo)
    with open(os.path.join(trace_dir, "kernel_layers.json"), "w") as f:
        json.dump(layer_of, f, indent=0, sort_keys=True)
    files = [os.path.join(root, f) for root, _, fs in os.walk(trace_dir)
             for f in fs if f.endswith(".xplane.pb")]
    events = device_kernel_events(max(files, key=os.path.getmtime))
    lt = layer_times(events, layer_of)
    iters = loop_iterations(lt["layers"]["transition"])
    te = cfg.transition_every
    arr = lt["layers"]["arrival"]
    calls = iters * te
    per_call = arr["s"] / max(calls, 1)
    live = int(arrivals) / max(calls, 1)
    bpl = arrival_bytes_per_lane(int(scene_data.stack_levels.shape[0]))
    roof = live * bpl / HBM_BYTES_PER_S
    trans = lt["layers"]["transition"]
    kernel_s = sum(v["s"] for v in lt["layers"].values()) + lt["other_s"]
    out = {
        "card": card, "spp": spp, "pool": cfg.pool_size,
        "transition_every": te, "super_iterations": iters,
        "kernel_events": len(events),
        "busy_s": lt["busy_s"], "window_s": lt["window_s"],
        "idle_share": lt["idle_share"], "kernel_s": kernel_s,
        "layer_s": {k: v["s"] for k, v in lt["layers"].items()},
        "other_s": lt["other_s"],
        "arrival_s_per_call": per_call,
        "arrival_live_lanes_per_call": live,
        "arrival_bytes_per_live_lane": bpl,
        "arrival_hbm_roofline_share": roof / per_call if per_call else None,
        "transition_s_per_iteration": trans["s"] / max(iters, 1),
        "transition_share_of_kernel_time": trans["s"] / kernel_s
        if kernel_s else None,
        "rays": int(rays), "occupancy": float(occ),
    }
    for k, v in out.items():
        say(f"[{card}] trace {k}: {v}")
    with open(os.path.join(trace_dir, "layer_times.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


# -- phase 7 ---------------------------------------------------------------

def phase_four_gpus(scene_data, config, params, devices):
    """The film tiled over four devices (mesh tile=4, spp=1) against the
    single-device fused pass on ``devices[0]`` with the same seeds."""
    from unity_webgpu_pathtracer_tpu.parallel.film_tiling import (
        make_mesh,
        multichip_fused_pass,
    )

    mesh = make_mesh(n_tile=4, n_spp=1, devices=devices[:4])
    pool = config.pool_size or None
    t0 = time.perf_counter()
    film_m, _occ, rays_m, _ = jax.jit(
        lambda sd, p: multichip_fused_pass(sd, config, p, 0, mesh,
                                           pool_size=pool))(scene_data, params)
    film_m = np.asarray(film_m)
    multi_s = time.perf_counter() - t0
    put = functools.partial(jax.device_put, device=devices[0])
    t0 = time.perf_counter()
    film_1, _occ1, rays_1, _ = fused_step()(
        put(scene_data), config, put(params), 0, pool_size=pool)
    film_1 = np.asarray(film_1)
    single_s = time.perf_counter() - t0
    rays_m, rays_1 = int(rays_m), int(rays_1)
    diff = np.abs(film_m - film_1).max(axis=1)
    scale = np.abs(film_1).max(axis=1)
    pix_ok = float((diff <= 1e-5 * scale).mean())
    mean_rel = abs(float(film_m.mean()) - float(film_1.mean())) / max(
        abs(float(film_1.mean())), 1e-30)
    say(f"four devices ({devices[0].device_kind}): {config.width}x"
        f"{config.height} {config.samples_per_pass} spp, rays {rays_m} vs "
        f"single {rays_1}, pixels within 1e-5 rel {pix_ok:.6f}, mean rel "
        f"diff {mean_rel:.3g}; compile+pass {multi_s:.1f} s (4 devices) vs "
        f"{single_s:.1f} s (1 device)")
    assert rays_m == rays_1, (rays_m, rays_1)
    assert pix_ok >= 0.999, pix_ok
    assert mean_rel <= 1e-5, mean_rel
    return {"rays": rays_m, "pixels_ok": pix_ok, "mean_rel": mean_rel}


# -- main ------------------------------------------------------------------

def build_bench(**kw):
    """The bench scene built for the device: ``(scene_data, config,
    params, build_s)``."""
    t0 = time.perf_counter()
    scene, config, params = bench.make_workload(**kw)
    scene_data = scene.build(config.traversal, octants=config.bvh_octants)
    jax.block_until_ready(scene_data)
    build_s = time.perf_counter() - t0
    say(f"bench scene: {int(scene_data.tris.shape[0])} triangle refs, "
        f"{config.width}x{config.height}, {config.samples_per_pass} spp, "
        f"pool {config.pool_size}; built in {build_s:.2f} s")
    return scene_data, config, params, build_s


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the four-GPU film-tiling phase")
    ap.add_argument("--out-dir", default=os.path.join(REPO, "build",
                                                      "chip_smoke"),
                    help="where the CLI's PNG and the trace are written")
    args = ap.parse_args(argv)

    try:
        devices = require_gpu()
    except NoGPUError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    enable_compile_cache()
    card = run_phase("1 device", phase_device, devices)

    if args.four_gpus:
        assert len(devices) >= 4, f"--four-gpus needs 4 GPUs, have {devices}"
        sd, config, params, _ = run_phase(
            "7 bench scene (4K)", build_bench, width=3840, height=2160,
            spp=1)
        run_phase("7 four GPUs", phase_four_gpus, sd, config, params,
                  devices)
    else:
        sd, config, params, build_s = run_phase("0 bench scene",
                                                build_bench)
        workloads = {
            "bench": (sd, config, params),
            "instanced builtin:tlas": example_workload("tlas"),
            "textured + analytic lights": example_workload(
                "texture", scene_fn=textured_lit_scene),
        }
        run_phase("2 XLA only", phase_xla_only, workloads)
        from tests.golden_common import SCENES

        run_phase("3 golden gates", phase_golden, SCENES)
        run_phase("4 traversal", phase_traversal, sd, config, params)
        run_phase("5 precision", phase_precision)
        run_phase("6 main path", phase_main, sd, config, params, card,
                  args.out_dir, build_s=build_s)
        run_phase("6 layer trace", phase_layer_trace, sd, config, params,
                  card, os.path.join(args.out_dir, "trace"))
    print(json.dumps({"ok": True, "device": device_info(devices)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
