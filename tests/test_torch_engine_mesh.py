"""The port's mesh Engine (``Engine(mesh_devices=N)`` / ``mesh_shape``) on the
CPU, every shard on the CPU.

Against the JAX package's mesh Engine on the 8 virtual CPU devices of
``tests/conftest.py``: stepping (1-D and 2-D, as ``tests/test_engine_mesh.py``)
and npz checkpoints both ways.  JAX's mesh fast render (Pallas in interpret
mode inside ``shard_map``) is not run; the mesh frames are held to the port's
single-device frames, which the other ``tests/test_torch_*.py`` files hold to
JAX: hit ids equal and rgb within rtol 3e-3 / atol 3e-4 (bit-equal where the
mesh renders the same pixels the same way), the fused loop within the same
tolerance (its history is f16 between frames, the single-device compose loop
keeps f32).  Also the viewer over a mesh Engine, the port's
``dryrun_multichip`` and the timing and profiling helpers.
"""

import dataclasses

import numpy as np
import pytest
import torch

import cellularautomatons3d_tpu as jca

import cellularautomatons3d_tpu_torch as ct
from cellularautomatons3d_tpu_torch.parallel import Sharded, dryrun_multichip
from cellularautomatons3d_tpu_torch.utils import metrics, profiling
from cellularautomatons3d_tpu_torch.viewer import server

from _torch_png import decode_png

COMMON = dict(grid_size=64, width=128, height=64, depth_samples=8, shadow_samples=4)
SMALL = dict(grid_size=32, width=64, height=32)
RTOL, ATOL = 3e-3, 3e-4


def engines(overrides, mesh, **kw):
    """(mesh Engine, single-device Engine) on the CPU, same config."""
    cfg = ct.EngineConfig(**overrides)
    return (ct.Engine(cfg.replace(**mesh), device="cpu", **kw),
            ct.Engine(cfg, device="cpu"))


def assert_frame(got, want, exact=False):
    assert got.shape == want.shape
    if exact:
        assert torch.equal(got, want)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)


# ------------------------------------------------- against the JAX Engine --
@pytest.mark.parametrize("mesh", [dict(mesh_devices=8), dict(mesh_shape=(4, 2))])
def test_mesh_engine_steps_match_jax(mesh):
    jeng = jca.Engine(jca.EngineConfig(**COMMON, **mesh))
    teng = ct.Engine(ct.EngineConfig(**COMMON, **mesh), device="cpu")
    assert isinstance(teng.state, Sharded) and teng.mesh.shape == dict(
        zip(("z", "y"), mesh.get("mesh_shape", (8,))))
    jeng.step(6)
    teng.step(6)
    np.testing.assert_array_equal(teng.state_dense(), jeng.state_dense())
    np.testing.assert_array_equal(ct.to_reference(teng.state), np.asarray(jeng.state))
    assert teng.state_dense().sum() > 7


@pytest.mark.parametrize("mesh", [dict(mesh_devices=8), dict(mesh_shape=(2, 4))])
def test_mesh_checkpoints_both_ways(tmp_path, mesh):
    """A JAX mesh Engine's npz loads into a port mesh Engine and the
    reverse: state, counters, camera and history shape (JAX's history is
    zero: its mesh Engine renders nothing here)."""
    cfg = dict(COMMON, **mesh, **ct.PRESETS["pyroclastic"], random_initial_state=True)
    jeng = jca.Engine(jca.EngineConfig(**cfg))
    jeng.step(3)
    jeng._frame_duration = 7.5
    jeng.camera.translate((1, 0, -1), 0.05)
    jeng.save(str(tmp_path / "jax.npz"))
    teng = ct.Engine.load(str(tmp_path / "jax.npz"), device="cpu")
    assert teng.mesh is not None and teng.mesh.size == 8
    np.testing.assert_array_equal(ct.to_reference(teng.state), np.asarray(jeng.state))
    assert teng.simulation_step == 3 and teng._frame_duration == 7.5
    np.testing.assert_array_equal(teng.camera.view_mat, jeng.camera.view_mat)
    assert teng.history.color.shape == tuple(jeng.history.color.shape)
    assert isinstance(teng.history.hit_idx, Sharded)

    teng.step(2)
    teng.render()
    teng.save(str(tmp_path / "port.npz"))
    back = jca.Engine.load(str(tmp_path / "port.npz"))
    assert back.mesh is not None and back.mesh.devices.size == 8
    np.testing.assert_array_equal(np.asarray(back.state), ct.to_reference(teng.state))
    np.testing.assert_array_equal(back.state_dense(), teng.state_dense())
    assert back.simulation_step == 5
    color, idx = ct.to_reference(teng.history)
    np.testing.assert_array_equal(np.asarray(back.history.color), color)
    np.testing.assert_array_equal(np.asarray(back.history.hit_idx), idx)
    assert (idx >= 0).any()


def test_from_reference_shards_over_a_mesh():
    jeng = jca.Engine(jca.EngineConfig(**SMALL, mesh_devices=4))
    jeng.step(4)
    mesh = ct.parallel.make_mesh(4, devices=["cpu"] * 4)
    state = ct.from_reference(np.asarray(jeng.state), mesh=mesh)
    assert isinstance(state, Sharded) and state.shards.shape == (4,)
    np.testing.assert_array_equal(ct.to_reference(state), np.asarray(jeng.state))
    hist = ct.from_reference(jeng.history, mesh=mesh)
    assert hist.color.shards[1].shape == (8, 64, 3)
    np.testing.assert_array_equal(ct.to_reference(hist)[1], np.asarray(jeng.history.hit_idx))


# --------------------------------- mesh frames against single-device frames --
@pytest.mark.parametrize("mesh", [dict(mesh_devices=8), dict(mesh_shape=(2, 4))])
def test_mesh_frames_match_single_device(mesh):
    """Row shards render their rows of the window: ids equal, rgb within the
    contract, over two frames (the second blends the row-sharded history)."""
    em, e1 = engines(COMMON, mesh)
    em.step(4)
    e1.step(4)
    for _ in range(2):
        assert_frame(em.render(), e1.render())
        assert torch.equal(em.history.hit_idx.full(), e1.history.hit_idx)
    assert (e1.history.hit_idx >= 0).any()
    assert em.history.color.shards.shape == em.mesh.devices.shape


def test_mesh_sliced_frame_matches_single_device():
    """Each row shard through the sliced path (K4 + K2's plain twins),
    forced at 64³ as ``tests/_smoke_child_mesh.py`` forces it."""
    em, e1 = engines(COMMON, dict(mesh_devices=8))
    for e in (em, e1):
        e.render_static = dataclasses.replace(e.render_static, force_sliced=True)
        e.step(4)
    assert_frame(em.render(), e1.render())
    assert torch.equal(em.history.hit_idx.full(), e1.history.hit_idx)


def test_mesh_multistate_frame_matches_single_device():
    cfg = dict(SMALL, **ct.PRESETS["pyroclastic"], random_initial_state=True)
    em, e1 = engines(cfg, dict(mesh_shape=(2, 2)))
    em.step(5)
    e1.step(5)
    np.testing.assert_array_equal(em.state_dense(), e1.state_dense())
    assert_frame(em.render(), e1.render())


def test_mesh_moved_frame_reprojects_within_row_shards():
    """After a camera move each shard reprojects its history within its own
    rows and rejects pixels that land outside them (the JAX mesh render's
    semantics): every pixel is the single-device moved frame's or, where
    rejected, the frame without history, most are the former, and some use
    the history."""
    em, e1 = engines(COMMON, dict(mesh_devices=8))
    fresh = ct.Engine(ct.EngineConfig(**COMMON), device="cpu")
    for e in (em, e1, fresh):
        e.step(4)
    for _ in range(3):
        em.render()
        e1.render()
    fresh.render()
    fresh.history = ct.render.renderer_fast.init_fast_history(128, 64, "cpu")
    for e in (em, e1, fresh):
        e.camera.rotate((1.0, 0.0, 0.0), 0.05)
        e.camera.rotate((0.0, 1.0, 0.0), 0.04)
    fm, f1, f0 = em.render(), e1.render(), fresh.render()
    close = lambda a, b: np.isclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL).all(-1)
    same, rejected = close(fm, f1), close(fm, f0)
    assert (same | rejected).all()
    assert same.mean() > 0.9
    assert (same & ~rejected).any()   # history kept across the move
    assert torch.equal(em.history.hit_idx.full(), e1.history.hit_idx)


def test_mesh_run_fused_matches_single_device():
    """The mesh fused loop (sharded steps + row-sharded frames) against the
    single-device loop, with and without reset_every."""
    em, e1 = engines(COMMON, dict(mesh_devices=8))
    em.step(4)
    e1.step(4)
    assert_frame(em.run_fused(3), e1.run_fused(3))
    assert em.simulation_step == e1.simulation_step == 7
    np.testing.assert_array_equal(em.state_dense(), e1.state_dense())
    assert_frame(em.run_fused(3, reset_every=2), e1.run_fused(3, reset_every=2))
    assert em.simulation_step == e1.simulation_step == 8
    np.testing.assert_array_equal(em.state_dense(), e1.state_dense())


def test_mesh_gi_temporal_sample_index():
    """As in the JAX Engine: a mesh render() passes no sample index (its
    frames equal the single-device render_frame_fast without one), the mesh
    fused loop passes the loop counter."""
    cfg = dict(SMALL, soft_shadow_samples=4, indirect_lighting=True, light_radius=0.08,
               gi_temporal=True)
    em, _ = engines(cfg, dict(mesh_devices=2))
    em.step(3)
    state = em._full_state()
    t = em._time_ms
    em._time_ms = t + 16.667   # the clock as render() advances it
    params = em.render_params()
    em._time_ms = t
    hist = ct.render.renderer_fast.init_fast_history(64, 32, "cpu")
    want, _, _ = ct.render.renderer_fast.render_frame_fast(em.render_static, state, params,
                                                           hist, True, None)
    assert_frame(em.render(), want)
    em2, e1 = engines(cfg, dict(mesh_devices=2))
    for e in (em2, e1):
        e.step(3)
    assert_frame(em2.run_fused(3), e1.run_fused(3))


def test_mesh_reference_pipeline_matches_single_device():
    """The reference pipeline renders the gathered state on the mesh's first
    device with the history split by rows: the single-device frame."""
    em, e1 = engines(dict(COMMON, pipeline="reference"), dict(mesh_devices=8))
    em.step(3)
    e1.step(3)
    for _ in range(2):
        assert_frame(em.render(), e1.render(), exact=True)
    assert isinstance(em.history.depth, Sharded)
    assert torch.equal(em.history.depth.full(), e1.history.depth)
    em.set("pipeline", "fast")   # the live switch re-shards the new history
    assert isinstance(em.history.hit_idx, Sharded)
    assert em.render().shape == (64, 128, 3)


def test_mesh_restart_and_device_list():
    """mesh_devices is restart-bound; the device list (repeats allowed) is
    the Engine's; a mesh the list cannot hold raises before anything
    changes."""
    cpu = torch.device("cpu")
    eng = ct.Engine(ct.EngineConfig(**SMALL, mesh_devices=2), device="cpu",
                    mesh_device_list=[cpu] * 4)
    assert eng.mesh.size == 2
    eng.step(2)
    eng.set("mesh_devices", 4)
    eng.restart()
    assert eng.mesh.size == 4 and eng.simulation_step == 0
    eng.step(2)
    state = eng.state_dense()
    eng.set("mesh_devices", 8)
    with pytest.raises(ValueError, match="needs 8 devices, have 4"):
        eng.restart()
    assert eng.restart_required and eng.mesh.size == 4
    np.testing.assert_array_equal(eng.state_dense(), state)
    eng.set("mesh_devices", 0)
    eng.restart()
    assert eng.mesh is None and isinstance(eng.state, torch.Tensor)


# ------------------------------------------------------------ the viewer --
def test_viewer_serves_a_mesh_engine():
    """As ``tests/_smoke_child_mesh.py``: frames as PNG, camera keys, the
    restart flow, on an Engine of 4 row and z shards."""
    vs = server.ViewerServer(device="cpu", mesh_devices=4, **SMALL)
    assert vs.engine.mesh.size == 4
    png = vs.frame_png()
    assert decode_png(png).shape == (32, 64, 3)
    out = vs.handle_input({"type": "keys", "dt": 0.016, "translate": [0, 0, 1],
                           "rotate": [0, 0, 0]})
    assert out["ok"]
    spec = {f["name"]: f for f in vs.field_spec()}
    assert spec["mesh_devices"]["value"] == 4
    vs.handle_input({"type": "param", "name": "grid_size", "value": 64})
    assert vs.engine.restart_required
    vs.handle_input({"type": "restart"})
    assert not vs.engine.restart_required and vs.engine.config.grid_size == 64
    assert vs.engine.mesh.size == 4
    assert decode_png(vs.frame_png()).shape == (32, 64, 3)


# ------------------------------------------------ dry run and the helpers --
def test_dryrun_multichip_on_cpu_shards():
    line = dryrun_multichip(4, devices=["cpu"] * 4)
    assert "4-shard mesh" in line and "2-D (2, 2)" in line


def test_metrics_and_profiling_on_the_cpu():
    eng = ct.Engine(ct.EngineConfig(**SMALL, mesh_devices=2), device="cpu")
    calls = []
    t = metrics.time_fn(lambda: calls.append(1) or eng.step(1).state, reps=3, warmup=1)
    assert t > 0 and len(calls) == 4
    metrics.device_sync([eng.state, {"x": torch.zeros(1)}])
    timer = metrics.Timer()
    for _ in range(2):
        with timer.section("step"):
            eng.step(1)
    assert set(timer.sections) == {"step"} and timer.sections["step"] > 0
    stats = profiling.profile_engine(eng, steps=2, frames=1)
    assert stats["grid_size"] == 32 and stats["step_ms"] > 0 and stats["fps"] > 0
    assert "Mesh" in stats["device"]
    with profiling.profile_trace() as prof:
        eng.step(1)
    assert any("cat" in e.key or "copy" in e.key for e in prof.key_averages())
