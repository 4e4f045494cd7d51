"""The port's slice as a whole: ``cellularautomatons3d_tpu_torch.Engine`` on
the CPU (plain torch twins of the kernels) against the JAX package's
``Engine`` (Pallas kernel in interpret mode) on the same configuration.

Contract: CA states bit-exact; frames within rtol 3e-3 / atol 3e-4; history
ids equal.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import cellularautomatons3d_tpu as jca
from cellularautomatons3d_tpu.render.renderer_fast import FastHistory as JaxHistory

import cellularautomatons3d_tpu_torch as ct
from cellularautomatons3d_tpu_torch.ops import ca_step
from cellularautomatons3d_tpu_torch.ops.occupancy import coarse_occupancy
from cellularautomatons3d_tpu_torch.render import render_fast, render_slab, renderer_fast
from cellularautomatons3d_tpu_torch.render.renderer import RenderHistory

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(grid_size=32, width=128, height=64)


def assert_frame(got, want):
    np.testing.assert_allclose(
        got.numpy(), np.asarray(want), rtol=3e-3, atol=3e-4
    )


def test_engine_matches_jax_engine():
    jeng = jca.Engine(jca.EngineConfig(**CFG))
    teng = ct.Engine(ct.EngineConfig(**CFG), device="cpu")

    jeng.step(5)
    teng.step(5)
    np.testing.assert_array_equal(ct.to_reference(teng.state), np.asarray(jeng.state))
    assert teng.simulation_step == jeng.simulation_step == 5

    for _ in range(2):  # the second frame blends the first one's history
        assert_frame(teng.render(), jeng.render())
    np.testing.assert_array_equal(
        teng.history.hit_idx.numpy(), np.asarray(jeng.history.hit_idx)
    )
    assert (teng.history.hit_idx >= 0).any()
    np.testing.assert_allclose(
        teng.history.color.float().numpy(),
        np.asarray(jeng.history.color, np.float32), rtol=3e-3, atol=1e-3,
    )

    assert_frame(teng.run_fused(3), jeng.run_fused(3))
    np.testing.assert_array_equal(ct.to_reference(teng.state), np.asarray(jeng.state))
    np.testing.assert_array_equal(
        teng.history.hit_idx.numpy(), np.asarray(jeng.history.hit_idx)
    )
    assert teng.simulation_step == jeng.simulation_step == 8


def test_history_round_trip_through_reference_form():
    eng = ct.Engine(ct.EngineConfig(**CFG), device="cpu")
    eng.step(4)
    eng.render()
    pair = ct.to_reference(eng.history)
    back = ct.from_reference(JaxHistory(*pair), device="cpu")
    assert torch.equal(back.color, eng.history.color)
    assert torch.equal(back.hit_idx, eng.history.hit_idx)
    words = ct.to_reference(eng.state)
    assert words.dtype == np.uint32
    assert torch.equal(ct.from_reference(words, device="cpu"), eng.state)


def test_run_fused_reset_every_pins_the_scene():
    eng = ct.Engine(ct.EngineConfig(**CFG), device="cpu")
    eng.step(3)
    start = eng.state.clone()
    eng.run_fused(4, reset_every=2)
    assert torch.equal(eng.state, start)  # reset after frames 2 and 4
    assert eng.simulation_step == 3  # the undone generations are not counted
    eng.run_fused(3, reset_every=2)
    assert not torch.equal(eng.state, start)  # frame 3 stepped past it
    assert eng.simulation_step == 4


def test_tick_cadence_and_restart():
    eng = ct.Engine(ct.EngineConfig(**CFG), device="cpu")
    eng.tick()
    eng.tick()
    assert eng.simulation_step == 0
    eng.tick()  # 3 × 16.667 ms ≥ 48 ms (main_pathtraced.js:1838-1847)
    assert eng.simulation_step == 1
    eng.set("gamma", 2.4)
    assert eng.config.gamma == 2.4 and not eng.restart_required
    eng.set("neighbourhood", "moore")
    assert eng.restart_required and eng.config.neighbourhood == "von neumann"
    eng.restart()
    assert eng.config.neighbourhood == "moore" and eng.simulation_step == 0
    assert eng.state_dense().sum() == 1


@pytest.mark.parametrize(
    "overrides",
    [
        dict(soft_shadow_samples=4),
        dict(indirect_lighting=True),
        dict(gi_temporal=True),
    ],
)
def test_lighting_configs_build_and_render(overrides):
    """Soft shadows, GI and gi_temporal (once refused) build and render."""
    eng = ct.Engine(ct.EngineConfig(**{**CFG, **overrides}), device="cpu")
    for key, value in overrides.items():
        assert getattr(eng.render_static, key) == value
    eng.step(4)
    frames = [eng.render(), eng.render(), eng.run_fused(2)]
    for f in frames:
        assert tuple(f.shape) == (CFG["height"], CFG["width"], 3)
        assert bool(torch.isfinite(f).all()) and float(f.max()) > 0.0
    assert (eng.history.hit_idx >= 0).any()


@pytest.mark.parametrize(
    "overrides", [dict(mesh_shape=(2, 1)), dict(mesh_devices=2, height=64)]
)
def test_mesh_configs_build_step_and_render(overrides):
    """mesh_shape and mesh_devices (once refused as ROADMAP item 12) build a
    mesh Engine, its shards on the CPU, whose state and frame equal the
    single-device Engine's (tests/test_torch_sharded.py and
    tests/test_torch_engine_mesh.py hold the mesh to JAX)."""
    eng = ct.Engine(ct.EngineConfig(**{**CFG, **overrides}), device="cpu")
    one = ct.Engine(ct.EngineConfig(**CFG), device="cpu")
    assert eng.mesh.size == 2 and [str(d) for d in eng.mesh.devices.flat] == ["cpu"] * 2
    eng.step(4)
    one.step(4)
    np.testing.assert_array_equal(eng.state_dense(), one.state_dense())
    frame = eng.render()
    assert tuple(frame.shape) == (CFG["height"], CFG["width"], 3)
    assert_frame(frame, one.render().numpy())
    assert torch.equal(eng.history.hit_idx.full(), one.history.hit_idx)


@pytest.mark.parametrize(
    "overrides", [dict(pipeline="reference"), dict(render_variant="simple")]
)
def test_reference_pipeline_builds_steps_and_renders(overrides):
    """The reference pipeline (once refused as ROADMAP item 11) and its
    simple variant build, step and render
    (tests/test_torch_reference_*.py hold them to JAX)."""
    eng = ct.Engine(ct.EngineConfig(**{**CFG, **overrides}), device="cpu")
    assert eng.config.pipeline == "reference"
    assert isinstance(eng.history, RenderHistory)
    assert eng.render_static.depth_samples == 35 and eng.render_static.shadow_samples == 30
    eng.step(4)
    frame = eng.tick()
    assert tuple(frame.shape) == (CFG["height"], CFG["width"], 3)
    assert bool(torch.isfinite(frame).all()) and float(frame.max()) > 0.0
    assert eng.history.depth.dtype == torch.float16 and eng.history.depth.any()


def test_live_set_of_pipeline_swaps_history_and_keeps_state():
    eng = ct.Engine(ct.EngineConfig(**CFG), device="cpu")
    eng.step(3)
    state = eng.state.clone()
    eng.set("pipeline", "reference")
    assert eng.config.pipeline == "reference" and not eng.restart_required
    assert isinstance(eng.history, RenderHistory) and torch.equal(eng.state, state)
    assert bool(torch.isfinite(eng.render()).all())


def test_live_set_of_lighting_fields_rebuilds_render_static():
    """As in the JAX Engine: a live set of a lighting field rebuilds the
    render constants, keeps the simulation state and renders with them."""
    eng = ct.Engine(ct.EngineConfig(**CFG), device="cpu")
    eng.step(4)
    state = eng.state.clone()
    hard = eng.render()
    for name, value in (("soft_shadow_samples", 4), ("indirect_lighting", True),
                        ("indirect_bounces", 2), ("gi_temporal", True)):
        eng.set(name, value)
        assert getattr(eng.render_static, name) == value
    assert not eng.restart_required and torch.equal(eng.state, state)
    lit = eng.render()
    assert bool(torch.isfinite(lit).all()) and not torch.equal(lit, hard)


def test_moving_camera_over_history_renders():
    """A camera move over a live history reprojects it (ROADMAP item 8,
    once a NotImplementedError): the frame renders, and the history the
    move keeps blends into it (tests/test_torch_camera.py holds it to JAX)."""
    eng = ct.Engine(ct.EngineConfig(**CFG), device="cpu")
    eng.step(4)
    eng.render()
    eng.render()
    hist = eng.history
    eng.camera.translate((1, 0, 0), 0.1)
    params = eng.render_params()
    frame = eng.render()
    assert bool(torch.isfinite(frame).all())
    rgb, depth, idx = render_fast.raytrace_tiles(
        eng.state, coarse_occupancy(eng.state), renderer_fast._cam_vec(params, 128, 64),
        grid_size=32, width=128, height=64, shadow=True)
    _, src, valid = renderer_fast.reproject_history(hist, rgb, depth, idx, params, 128, 64)
    assert int(valid.sum()) > 0 and bool((src[valid] >= 0).all())
    assert torch.equal(eng.history.hit_idx, idx)


def test_cuda_engine_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        ct.Engine(ct.EngineConfig(**CFG), device="cuda")


def test_cuda_wrappers_refuse_cpu_tensors_and_do_not_fall_back():
    spec = ct.AutomatonSpec.from_config(ct.EngineConfig(**CFG))
    packed = ct.from_reference(ct.pack_grid(ct.seed_center(32)), device="cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        ca_step.fires_plane_cuda(packed, spec)
    # A non-CPU tensor takes the kernel path, which raises here.
    with pytest.raises((ValueError, RuntimeError)):
        ca_step.step_packed(packed.to("meta"), spec)
    assert ca_step.fires_plane_cuda.launches == 0
    assert render_fast.raytrace_cuda.launches == 0
    assert render_slab.shadow_sweep_cuda.launches == 0
    assert render_slab.cell_state_cuda.launches == 0


def test_port_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None; "
        "import cellularautomatons3d_tpu_torch as ct; "
        "import cellularautomatons3d_tpu_torch.viewer.server, "
        "cellularautomatons3d_tpu_torch.utils.image, cellularautomatons3d_tpu_torch.native, "
        "cellularautomatons3d_tpu_torch.render.raymarch; "
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules "
        "if sys.modules[m] is not None); "
        "assert not any(m.split('.')[0] == 'cellularautomatons3d_tpu' for m in sys.modules); "
        "e = ct.Engine(grid_size=32, width=32, height=16, device='cpu'); "
        "e.step(1); assert e.state_dense().sum() == 7; "
        "r = ct.Engine(grid_size=32, width=32, height=16, pipeline='reference', "
        "device='cpu'); r.step(2); r.render(); print('ok')"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
