"""chip_smoke.py and bench.py on the CPU: every phase at a tiny size (the
four-GPU phase on four virtual CPU devices), the refusal without a GPU,
the last-line format and the trace reduction.  ``test_chip_smoke_on_gpu``
runs the real smoke in a child process where a GPU is present."""

import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest

import bench
import chip_smoke as cs
from unity_webgpu_pathtracer_tpu.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tiny_bench():
    return cs.build_bench(width=48, height=32, target_tris=6000, spp=2,
                          pool=1000)


@pytest.fixture(scope="module")
def tiny_workloads(tiny_bench):
    sd, config, params, _ = tiny_bench
    return {
        "bench": (sd, config, params),
        "tlas": cs.example_workload("tlas", size=16, spp=1, pool=256),
        "textured_lit": cs.example_workload(
            "texture", size=16, spp=1, pool=256,
            scene_fn=cs.textured_lit_scene),
    }


def test_phase_device_reports():
    card = cs.phase_device(jax.devices())
    assert isinstance(card, str) and card


@pytest.mark.parametrize("label", ["bench", "tlas", "textured_lit"])
def test_phase_xla_only(tiny_workloads, label):
    sd, config, params = tiny_workloads[label]
    cs.phase_xla_only({label: (sd, config, params)})
    if label == "textured_lit":
        assert config.has_lights and config.has_textures
    if label == "tlas":
        assert sd.inst_w2l.shape[0] > 0


@pytest.mark.parametrize("jaxpr,hlo,n", [
    ("", "stablehlo.custom_call @some_kernel(%0)", 1),
    ("pallas_call[name=kernel]", "", 1),
    ("", 'custom_call_target="mosaic_gpu"', 1),
    ("lambda a: sin a", "stablehlo.sine %0", 0),
])
def test_non_xla_findings(jaxpr, hlo, n):
    assert len(cs.non_xla_findings(jaxpr, hlo)) == n


@pytest.mark.parametrize("gain,ok", [(1.0, True), (1.05, False)])
def test_phase_golden_gate(monkeypatch, gain, ok):
    """The phase applies the calibrated gates unchanged: the fixture's own
    mean passes, a 5% gain fails."""
    import tests.golden_common as gc

    def fake_passes(name, seeds):
        m = gc.load_golden(name)["mean"] * gain
        return np.stack([m] * len(seeds))

    monkeypatch.setattr(gc, "render_pass_means", fake_passes)
    if ok:
        assert set(cs.phase_golden(["brdf"])) == {"brdf"}
    else:
        with pytest.raises(AssertionError):
            cs.phase_golden(["brdf"])


def test_phase_traversal(tiny_bench):
    sd, config, params, _ = tiny_bench
    out = cs.phase_traversal(sd, config, params, grid=(24, 16),
                             pool_grid=(40, 25))
    assert out["agree"] == 1.0 and out["t_rel"] == 0.0


def test_phase_precision():
    out = cs.phase_precision(width=96, height=54, lanes=4096)
    assert out["ray_err"] <= 1e-6 and out["aces_err"] <= 1e-5


def test_phase_main_renders_and_cli(tiny_bench, tmp_path):
    sd, config, params, build_s = tiny_bench
    out = cs.phase_main(sd, config, params, "test card", str(tmp_path),
                        passes=1, build_s=build_s, cli_size=16, cli_spp=2)
    assert len(out["pass_mrays"]) == 1 and out["pass_mrays"][0] > 0
    assert os.path.exists(tmp_path / "sponza_like.png")


def test_phase_four_gpus_on_virtual_devices():
    devices = jax.devices()
    assert len(devices) >= 4
    sd, config, params, _ = cs.build_bench(width=32, height=16,
                                           target_tris=3000, spp=1, pool=300)
    out = cs.phase_four_gpus(sd, config, params, devices)
    assert out["rays"] > 0 and out["pixels_ok"] == 1.0


def test_layer_trace_reduction_on_cpu(tiny_bench, tmp_path):
    """A recorded CPU trace of a fused pass reduces to per-layer times:
    every layer's kernels are found and the loop count is consistent."""
    sd, config, params, _ = tiny_bench
    step = cs.fused_step()
    args = (sd, config, params, 1)
    jax.block_until_ready(step(*args, pool_size=config.pool_size))
    with jax.profiler.trace(str(tmp_path)):
        jax.block_until_ready(step(*args, pool_size=config.pool_size))
    hlo = step.lower(*args, pool_size=config.pool_size).compile().as_text()
    layer_of = profiling.hlo_layers(hlo)
    assert set(layer_of.values()) == set(profiling.LAYERS)
    path = next(os.path.join(r, f) for r, _, fs in os.walk(tmp_path)
                for f in fs if f.endswith(".xplane.pb"))
    events = profiling.device_kernel_events(path, "/host:CPU", "tf_XLA")
    lt = profiling.layer_times(events, layer_of)
    assert lt["layers"]["arrival"]["s"] > 0
    assert lt["layers"]["transition"]["s"] > 0
    assert profiling.loop_iterations(lt["layers"]["transition"]) > 1
    assert 0.0 <= lt["idle_share"] < 1.0


def test_hlo_layers_attributes_fusions():
    hlo = """
%fused_computation.1 (p: f32[4]) -> f32[4] {
  %p = f32[4]{0} parameter(0)
  %sine.1 = f32[4]{0} sine(%p), metadata={op_name="jit(f)/while/body/arrival/sin"}
  ROOT %cos.1 = f32[4]{0} cosine(%sine.1), metadata={op_name="cos"}
}

ENTRY %main (a: f32[4]) -> f32[4] {
  %a = f32[4]{0} parameter(0)
  %loop_sine_fusion.2 = f32[4]{0} fusion(%a), kind=kLoop, calls=%fused_computation.1
  ROOT %add.3 = f32[4]{0} add(%a, %a), metadata={op_name="jit(f)/transition/add"}
}
"""
    layers = profiling.hlo_layers(hlo)
    assert layers["loop_sine_fusion_2"] == "arrival"
    assert layers["add_3"] == "transition"
    # The second event is replayed from a CUDA graph: its hlo_op names
    # the command buffer, its kernel name the fusion.
    events = [("loop_sine_fusion_2", "loop_sine_fusion.2", 0.0, 10.0),
              ("loop_sine_fusion_2", "command_buffer", 10.0, 2.0),
              ("add_3", "add.3", 20.0, 5.0), ("other", "copy.1", 30.0, 10.0)]
    lt = profiling.layer_times(events, layers)
    assert lt["layers"]["arrival"]["s"] == pytest.approx(1.2e-8)
    assert lt["layers"]["arrival"]["per_op_launches"] == {
        "loop_sine_fusion_2": 2}
    assert lt["other_s"] == pytest.approx(1e-8)
    assert lt["busy_s"] == pytest.approx(27e-9)
    assert lt["idle_share"] == pytest.approx(0.325)


def test_arrival_bytes_per_lane():
    # 384-byte row + (7*4 + 1 + 2*4*D + 36) read + (7*4 + 1 + 2*4*D) written
    assert cs.arrival_bytes_per_lane(10) == 384 + 145 + 109


def test_main_refuses_cpu():
    out = io.StringIO()
    with redirect_stdout(out):
        rc = cs.main([])
    assert rc != 0
    assert '"ok"' not in out.getvalue()


def test_main_last_line_format(monkeypatch, tiny_bench):
    """With every phase stubbed, the last stdout line is exactly the
    contract's JSON object, with the device as JAX reports it."""
    devices = jax.devices()[:1]
    monkeypatch.setattr(cs, "require_gpu", lambda: devices)
    monkeypatch.setattr(cs, "build_bench", lambda **kw: tiny_bench)
    for name in ("phase_device", "phase_xla_only", "phase_golden",
                 "phase_traversal", "phase_precision", "phase_main",
                 "phase_layer_trace", "example_workload"):
        monkeypatch.setattr(cs, name, lambda *a, **k: "stub")
    out = io.StringIO()
    with redirect_stdout(out):
        assert cs.main([]) == 0
    lines = out.getvalue().strip().splitlines()
    last = json.loads(lines[-1])
    assert last == {"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": 1}}
    assert all("== phase" in l for l in lines[:-1] if l.startswith("=="))


def test_bench_refuses_cpu(capsys):
    assert bench.main() != 0
    captured = capsys.readouterr()
    assert "cpu" in captured.err and captured.out == ""


@pytest.fixture
def gpu_present():
    """Decided when the test runs: a GPU that nvidia-smi can see."""
    try:
        out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        pytest.skip("no GPU: nvidia-smi not found")
    if out.returncode != 0 or "GPU" not in out.stdout:
        pytest.skip("no GPU visible to nvidia-smi")


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu_present):
    """The whole smoke in a child process on the card; pytest itself
    stays on the CPU."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=1500)
    assert out.returncode == 0, out.stderr[-3000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"
