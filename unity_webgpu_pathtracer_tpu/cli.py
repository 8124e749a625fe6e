"""Command-line renderer.

Examples::

    python -m unity_webgpu_pathtracer_tpu.cli render builtin:cornell \
        --spp 256 --size 512 --out cornell.png
    python -m unity_webgpu_pathtracer_tpu.cli render model.glb --spp 64 \
        --env sky.hdr --tonemap aces
    python -m unity_webgpu_pathtracer_tpu.cli examples
"""

from __future__ import annotations

import argparse
import sys
import time


TONEMAPS = {"none": 0, "aces": 1, "filmic": 2, "reinhard": 3, "lottes": 4}


def _load_scene(spec: str):
    from unity_webgpu_pathtracer_tpu.models.examples import EXAMPLES

    if spec.startswith("builtin:"):
        name = spec.split(":", 1)[1]
        if name not in EXAMPLES:
            raise SystemExit(f"unknown builtin '{name}'; try: {', '.join(EXAMPLES)}")
        return EXAMPLES[name]()
    if spec.endswith(".obj"):
        from unity_webgpu_pathtracer_tpu.scene.obj import load_obj

        scene = load_obj(spec)
        return scene, _frame_camera(scene), {}
    if spec.endswith((".glb", ".gltf")):
        from unity_webgpu_pathtracer_tpu.scene.gltf import load_gltf

        scene = load_gltf(spec)
        return scene, _frame_camera(scene), {}
    raise SystemExit(f"unrecognized scene spec: {spec}")


def _frame_camera(scene) -> dict:
    """Auto-frame a loaded model from its world AABB (a 3/4 view that fits
    the whole bounding sphere at 40 deg vfov), overridable by --eye/--target."""
    import numpy as np

    lo, hi = scene.world_bounds()
    center = (lo + hi) / 2
    radius = float(np.linalg.norm(hi - lo)) / 2 or 1.0
    dist = radius / np.sin(np.radians(40.0) / 2) * 1.1
    d = np.array([0.55, 0.35, 0.76])
    d /= np.linalg.norm(d)
    return dict(eye=tuple(center + d * dist), target=tuple(center),
                fov_y_deg=40.0)


def cmd_render(args):
    from unity_webgpu_pathtracer_tpu.api import Renderer
    from unity_webgpu_pathtracer_tpu.config import PostParams, RenderConfig, SKY_MODE_ENVIRONMENT
    from unity_webgpu_pathtracer_tpu.render.camera import make_camera_params
    from unity_webgpu_pathtracer_tpu.utils.image import read_hdr

    scene, cam, overrides = _load_scene(args.scene)
    if args.env:
        scene.set_environment(read_hdr(args.env))
        overrides = dict(overrides, sky_mode=SKY_MODE_ENVIRONMENT,
                         has_environment_texture=True)
    if args.eye:
        cam["eye"] = tuple(float(x) for x in args.eye.split(","))
    if args.target:
        cam["target"] = tuple(float(x) for x in args.target.split(","))
    if args.fov:
        cam["fov_y_deg"] = args.fov

    width = height = args.size
    overrides = dict(overrides)
    overrides.setdefault("traversal", args.traversal)
    overrides["has_lights"] = bool(scene.lights) or overrides.get("has_lights", False)
    overrides["has_textures"] = bool(scene.textures) or overrides.get("has_textures", False)
    overrides["has_normal_maps"] = (
        overrides["has_textures"]
        and any(m.normal_texture >= 0 for m in scene.materials)
    ) or overrides.get("has_normal_maps", False)
    # Production defaults: fused + wide16 at transition cadence 8 (the
    # bench config); every other backend remains selectable for
    # cross-checking.
    if args.integrator == "fused" and "transition_every" not in overrides:
        overrides["transition_every"] = 8
    config = RenderConfig(
        width=width, height=height,
        samples_per_pass=min(args.spp, args.spp_per_pass),
        max_bounces=args.bounces,
        integrator=args.integrator,
        **overrides,
    )
    params = make_camera_params(width=width, height=height, **cam)
    r = Renderer(scene, config, params)

    t0 = time.time()
    passes = max(1, args.spp // config.samples_per_pass)
    for i in range(passes):
        r.step()
        if args.verbose:
            print(f"pass {i + 1}/{passes} ({r.sample_count} spp, "
                  f"{time.time() - t0:.1f}s)", file=sys.stderr)
    r.film.accum.block_until_ready()
    print(f"rendered {r.sample_count} spp in {time.time() - t0:.1f}s",
          file=sys.stderr)

    post = PostParams(mode=TONEMAPS[args.tonemap], exposure=args.exposure)
    r.save_png(args.out, post)
    print(args.out)


def cmd_view(args):
    """Interactive viewer: progressive render + fly camera + material
    sliders in a local browser (FreeViewCamera.cs / DisneyBRDFTest.cs /
    PathTracerGUI.cs analogues — see viewer.py)."""
    from unity_webgpu_pathtracer_tpu.api import Renderer
    from unity_webgpu_pathtracer_tpu.config import PostParams, RenderConfig
    from unity_webgpu_pathtracer_tpu.render.camera import make_camera_params
    from unity_webgpu_pathtracer_tpu.viewer import Viewer, serve

    scene, cam, overrides = _load_scene(args.scene)
    width = height = args.size
    overrides = dict(overrides)
    overrides.setdefault("traversal", args.traversal)
    overrides["has_lights"] = bool(scene.lights) or overrides.get("has_lights", False)
    overrides["has_textures"] = bool(scene.textures) or overrides.get("has_textures", False)
    config = RenderConfig(
        width=width, height=height, samples_per_pass=args.spp_per_pass,
        max_bounces=args.bounces, integrator="fused",
        transition_every=overrides.pop("transition_every", 8),
        **overrides,
    )
    params = make_camera_params(width=width, height=height, **cam)
    r = Renderer(scene, config, params)
    v = Viewer(r, cam, post=PostParams(mode=TONEMAPS[args.tonemap]),
               max_spp=args.max_spp, reproject=args.reproject)
    print(f"http://{args.host}:{args.port}/", file=sys.stderr)
    serve(v, host=args.host, port=args.port)


def cmd_examples(_args):
    from unity_webgpu_pathtracer_tpu.models.examples import EXAMPLES

    for name in EXAMPLES:
        print(f"builtin:{name}")


def cmd_animate(args):
    """Render a frame sequence: orbiting camera (FreeViewCamera.cs
    analogue, headless) and/or animated instance transforms on TLAS scenes
    (Bounce.cs analogue — TLAS-only rebuild per frame, accumulation
    reset). Writes out-0000.png .. out-NNNN.png."""
    import os

    import numpy as np

    from unity_webgpu_pathtracer_tpu.api import Renderer
    from unity_webgpu_pathtracer_tpu.config import PostParams, RenderConfig
    from unity_webgpu_pathtracer_tpu.render.camera import make_camera_params

    scene, cam, overrides = _load_scene(args.scene)
    width = height = args.size
    overrides = dict(overrides)
    overrides.setdefault("traversal", args.traversal)
    overrides["has_lights"] = bool(scene.lights) or overrides.get("has_lights", False)
    overrides["has_textures"] = bool(scene.textures) or overrides.get("has_textures", False)
    config = RenderConfig(
        width=width, height=height, samples_per_pass=args.spp,
        max_bounces=args.bounces, integrator="fused",
        transition_every=overrides.pop("transition_every", 8),
        **overrides,
    )
    params = make_camera_params(width=width, height=height, **cam)
    r = Renderer(scene, config, params)
    base, ext = os.path.splitext(args.out)
    eye0 = np.asarray(cam["eye"], np.float32)
    target = np.asarray(cam.get("target", (0, 0, 0)), np.float32)
    bounce_ids = list(range(len(scene.instances) - 1)) if args.bounce else []

    for f in range(args.frames):
        phase = 2.0 * np.pi * f / max(args.frames, 1)
        if args.orbit:
            rel = eye0 - target
            c, s = np.cos(phase), np.sin(phase)
            rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
            eye = target + rot @ rel
            params = make_camera_params(
                width=width, height=height,
                **{**cam, "eye": tuple(float(x) for x in eye)})
            r.update_camera(params)
        for i in bounce_ids:
            mid, t0, _m = scene.instances[i]
            t = np.array(t0, np.float32).copy()
            t[1, 3] = 0.4 + abs(np.sin(phase + i)) * 1.2
            r.update_instance_transform(i, t)
        r.render(1)
        path = f"{base}-{f:04d}{ext or '.png'}"
        r.save_png(path, PostParams(mode=TONEMAPS[args.tonemap]))
        print(path, file=sys.stderr)
    print(f"{base}-0000{ext or '.png'} .. {base}-{args.frames - 1:04d}{ext or '.png'}")


def main(argv=None):
    # Product entry point: warm starts in seconds instead of a cold XLA
    # compile (the analogue of Unity's on-disk shader cache).
    from unity_webgpu_pathtracer_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    p = argparse.ArgumentParser(prog="unity_webgpu_pathtracer_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render a scene to PNG")
    pr.add_argument("scene", help="builtin:<name> | path.obj | path.glb")
    pr.add_argument("--out", default="render.png")
    pr.add_argument("--size", type=int, default=512)
    pr.add_argument("--spp", type=int, default=64)
    pr.add_argument("--spp-per-pass", type=int, default=4)
    pr.add_argument("--bounces", type=int, default=5)
    pr.add_argument("--integrator", default="fused",
                    choices=["megakernel", "wavefront", "fused"])
    pr.add_argument("--traversal", default="wide16",
                    choices=["bruteforce", "mbvh", "skip", "wide", "wide2", "wide8", "wide16"])
    pr.add_argument("--env", help="HDRI .hdr environment map")
    pr.add_argument("--tonemap", default="aces", choices=list(TONEMAPS))
    pr.add_argument("--exposure", type=float, default=1.0)
    pr.add_argument("--eye", help="camera eye 'x,y,z'")
    pr.add_argument("--target", help="camera target 'x,y,z'")
    pr.add_argument("--fov", type=float)
    pr.add_argument("-v", "--verbose", action="store_true")
    pr.set_defaults(fn=cmd_render)

    pe = sub.add_parser("examples", help="list builtin scenes")
    pe.set_defaults(fn=cmd_examples)

    pv = sub.add_parser("view", help="interactive browser viewer "
                                     "(fly camera + material sliders)")
    pv.add_argument("scene", help="builtin:<name> | path.obj | path.glb")
    pv.add_argument("--size", type=int, default=256)
    pv.add_argument("--spp-per-pass", type=int, default=2)
    pv.add_argument("--max-spp", type=int, default=4096)
    pv.add_argument("--bounces", type=int, default=4)
    pv.add_argument("--traversal", default="wide16",
                    choices=["bruteforce", "mbvh", "skip", "wide", "wide2",
                             "wide8", "wide16"])
    pv.add_argument("--tonemap", default="aces", choices=list(TONEMAPS))
    pv.add_argument("--reproject", action="store_true",
                    help="fly-cam moves warp accumulated history "
                         "(temporal reprojection) instead of resetting")
    pv.add_argument("--host", default="127.0.0.1")
    pv.add_argument("--port", type=int, default=8000)
    pv.set_defaults(fn=cmd_view)

    pa = sub.add_parser(
        "animate",
        help="render a frame sequence (orbit camera / bounce instances)")
    pa.add_argument("scene", help="builtin:<name> | path.obj | path.glb")
    pa.add_argument("--out", default="frame.png",
                    help="frame path stem; writes stem-0000.png ...")
    pa.add_argument("--frames", type=int, default=8)
    pa.add_argument("--size", type=int, default=256)
    pa.add_argument("--spp", type=int, default=8)
    pa.add_argument("--bounces", type=int, default=4)
    pa.add_argument("--traversal", default="wide16",
                    choices=["wide", "wide2", "wide8", "wide16"])
    pa.add_argument("--orbit", action="store_true",
                    help="orbit the camera around the target per frame")
    pa.add_argument("--bounce", action="store_true",
                    help="animate instance heights (TLAS scenes; Bounce.cs)")
    pa.add_argument("--tonemap", default="aces", choices=list(TONEMAPS))
    pa.set_defaults(fn=cmd_animate)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
