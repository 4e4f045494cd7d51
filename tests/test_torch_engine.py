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
from cellularautomatons3d_tpu_torch.render import render_fast

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
    back = ct.from_reference(JaxHistory(*pair))
    assert torch.equal(back.color, eng.history.color)
    assert torch.equal(back.hit_idx, eng.history.hit_idx)
    words = ct.to_reference(eng.state)
    assert words.dtype == np.uint32
    assert torch.equal(ct.from_reference(words), eng.state)


def test_run_fused_reset_every_pins_the_scene():
    eng = ct.Engine(ct.EngineConfig(**CFG), device="cpu")
    eng.step(3)
    start = eng.state.clone()
    eng.run_fused(4, reset_every=2)
    assert torch.equal(eng.state, start)  # reset after frames 2 and 4
    eng.run_fused(3, reset_every=2)
    assert not torch.equal(eng.state, start)  # frame 3 stepped past it


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
    "overrides,item",
    [
        (dict(soft_shadow_samples=4), "item 6"),
        (dict(indirect_lighting=True), "item 6"),
        (dict(gi_temporal=True), "item 6"),
        (dict(grid_size=288), "item 7"),
        (dict(pipeline="reference"), "item 11"),
        (dict(mesh_devices=2, height=64), "item 12"),
        (dict(total_states=5), "item 14"),
    ],
)
def test_unported_configs_raise(overrides, item):
    with pytest.raises(NotImplementedError, match=item):
        ct.Engine(ct.EngineConfig(**{**CFG, **overrides}), device="cpu")


def test_live_set_of_unported_setting_raises_and_changes_nothing():
    eng = ct.Engine(ct.EngineConfig(**CFG), device="cpu")
    with pytest.raises(NotImplementedError, match="item 6"):
        eng.set("soft_shadow_samples", 4)
    assert eng.config.soft_shadow_samples == 1


def test_moving_camera_over_history_raises():
    eng = ct.Engine(ct.EngineConfig(**CFG), device="cpu")
    eng.step(4)
    eng.render()  # first frame: empty history, equivalent to static
    eng.camera.translate((1, 0, 0), 0.1)
    with pytest.raises(NotImplementedError, match="item 8"):
        eng.render()


def test_cuda_engine_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        ct.Engine(ct.EngineConfig(**CFG), device="cuda")


def test_cuda_wrappers_refuse_cpu_tensors_and_do_not_fall_back():
    spec = ct.AutomatonSpec.from_config(ct.EngineConfig(**CFG))
    packed = ct.from_reference(ct.pack_grid(ct.seed_center(32)))
    with pytest.raises(ValueError, match="CUDA tensor"):
        ca_step.fires_plane_cuda(packed, spec)
    # A non-CPU tensor takes the kernel path, which raises here.
    with pytest.raises((ValueError, RuntimeError)):
        ca_step.step_packed(packed.to("meta"), spec)
    assert ca_step.fires_plane_cuda.launches == 0
    assert render_fast.raytrace_cuda.launches == 0


def test_port_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None; "
        "import cellularautomatons3d_tpu_torch as ct; "
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules "
        "if sys.modules[m] is not None); "
        "e = ct.Engine(grid_size=32, width=32, height=16, device='cpu'); "
        "e.step(1); assert e.state_dense().sum() == 7; print('ok')"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
