"""``Engine(pipeline="reference")`` and ``render_variant="simple"``: the
port's Engine on the CPU against the JAX package's Engine on the same
configuration (32³ / 64×48), with the JAX engine's jitted ``render_frame``;
the live pipeline switch, live sample counts, ``run_fused``'s refusal and
npz checkpoints with ``history_depth``.

States are held bit-exact; frames by tests/_torch_reference_scene.py's
comparison, with the mismatch fractions each test states.
"""

import copy

import numpy as np
import pytest
import torch

import cellularautomatons3d_tpu as jca
from cellularautomatons3d_tpu.render.renderer import RenderHistory as JaxRenderHistory

import cellularautomatons3d_tpu_torch as ct
from cellularautomatons3d_tpu_torch.render.renderer import RenderHistory
from cellularautomatons3d_tpu_torch.render.renderer_fast import FastHistory

from _torch_multistate_scene import one_torch_thread, random_ages  # noqa: F401
from _torch_reference_scene import compare

CFG = dict(grid_size=32, width=64, height=48, pipeline="reference")


def move(cam, i):
    """A translate and a mouse look, alternating sides."""
    s = 1 if i % 2 == 0 else -1
    cam.translate((s, 0, -1), 0.03)
    cam.mouse_look(5.0 * s, -2.0)


def frame_triple(frame, history):
    """(presentation, history colour, history depth) as numpy."""
    as_np = lambda x: x.numpy() if torch.is_tensor(x) else np.asarray(x)  # noqa: E731
    return as_np(frame), as_np(history.color), as_np(history.depth)


def run_both(overrides, ticks, dense=None):
    """A JAX Engine and a port Engine of one configuration, optionally
    loaded with the dense age grid ``dense``, through ``ticks`` ticks (a
    camera move before each after the first).  Returns the engines and the
    frame triples of each tick."""
    jeng = jca.Engine(jca.EngineConfig(**CFG, **overrides))
    teng = ct.Engine(ct.EngineConfig(**CFG, **overrides), device="cpu")
    if dense is not None:
        jeng.set_state_dense(dense)
        teng.set_state_dense(dense)
    frames = []
    for i in range(ticks):
        if i:
            move(jeng.camera, i)
            move(teng.camera, i)
        jf = jeng.tick()
        tf = teng.tick()
        frames.append((frame_triple(tf, teng.history), frame_triple(jf, jeng.history)))
        np.testing.assert_array_equal(ct.to_reference(teng.state), np.asarray(jeng.state))
    assert teng.simulation_step == jeng.simulation_step > 0
    return jeng, teng, frames


@pytest.fixture(scope="module")
def clustered_engines():
    """The default rule from a seeded random volume (8 % live)."""
    dense = (np.random.default_rng(3).random((32,) * 3) < 0.08).astype(np.uint8)
    return run_both({}, ticks=5, dense=dense)


def test_engine_matches_jax_engine(clustered_engines):
    """Five ticks with camera moves, the CA stepping on the reference's
    cadence.  Measured: up to 2.51 % of the pixels in depth and 2.57 % in
    rgb differ from the jitted JAX Engine's frames (each tick's mismatches
    carry into the next through the history)."""
    _, teng, frames = clustered_engines
    assert isinstance(teng.history, RenderHistory)
    for got, want in frames:
        compare(got, want, depth=3.5e-2, rgb=3.5e-2)
    assert (frames[-1][0][0].sum(-1) > 0).sum() > 100


def test_amoeba_simple_variant_matches_jax_engine():
    """BASELINE config 1's rule, amoeba-445 (Moore 4/4, 5 states), in the
    simple variant.  The preset dies out from the Engine's seed, so both
    engines load the same seeded random grid of ages.  Measured: up to
    2.77 % of the pixels in depth and 1.92 % in rgb."""
    overrides = dict(ct.PRESETS["amoeba-445"], render_variant="simple")
    dense = random_ages(32, 5, 17, p_dead=0.7)
    jeng, teng, frames = run_both(overrides, ticks=4, dense=dense)
    assert teng.config.pipeline == "reference" and teng.spec.total_states == 5
    for got, want in frames:
        compare(got, want, depth=3.5e-2, rgb=2.5e-2)
    assert teng.state_dense().any()


def test_live_pipeline_switch_swaps_history():
    """As tests/test_engine.py:158-171: a live switch rebuilds the history
    as the other pipeline's type, keeps the state, and renders."""
    eng = ct.Engine(ct.EngineConfig(grid_size=32, width=64, height=48), device="cpu")
    eng.step(4)
    eng.render()
    state = eng.state.clone()
    eng.set("pipeline", "reference")
    assert not eng.restart_required and isinstance(eng.history, RenderHistory)
    assert eng.history.depth.shape == (48, 64, 2) and not eng.history.depth.any()
    f = eng.render()
    assert bool(torch.isfinite(f).all()) and float(f.max()) > 0
    assert eng.history.depth.any()
    eng.set("render_variant", "simple")  # stays on the reference pipeline
    assert isinstance(eng.history, RenderHistory) and eng.history.depth.any()
    assert bool(torch.isfinite(eng.render()).all())
    eng.set("render_variant", "clustered")
    eng.set("pipeline", "fast")
    assert isinstance(eng.history, FastHistory)
    assert bool(torch.isfinite(eng.render()).all()) and torch.equal(eng.state, state)
    eng.set("width", 32)
    assert eng.history.color.shape == (48, 32, 3)


def test_live_sample_count_change_applies():
    """As tests/test_engine.py:173-184: depth / shadow samples are live."""
    eng = ct.Engine(ct.EngineConfig(**CFG), device="cpu")
    eng.step(4)
    eng.set("depth_samples", 40)
    eng.set("shadow_samples", 12)
    assert eng.render_static.depth_samples == 40 and eng.render_static.shadow_samples == 12
    eng.set("indirect_lighting", True)
    assert eng.render_static.indirect_lighting
    assert bool(torch.isfinite(eng.render()).all())


def test_run_fused_requires_the_fast_pipeline():
    eng = ct.Engine(ct.EngineConfig(**CFG), device="cpu")
    with pytest.raises(ValueError, match="run_fused requires the fast pipeline"):
        eng.run_fused(2)
    assert eng.simulation_step == 0


def test_checkpoint_history_depth_both_directions(tmp_path, clustered_engines):
    """npz files with ``history_depth``: the port's loads in JAX and JAX's
    in the port, state, history, camera and counters equal; the port's
    loaded Engine renders the next frame of the one it saved."""
    jeng, teng, _ = clustered_engines
    for eng, path in ((teng, tmp_path / "port.npz"), (jeng, tmp_path / "jax.npz")):
        eng.save(str(path))
        with np.load(path) as data:
            assert "history_depth" in data and "history_idx" not in data
    back = {"port": ct.Engine.load(str(tmp_path / "jax.npz"), device="cpu"),
            "jax": jca.Engine.load(str(tmp_path / "port.npz"))}
    for loaded, src in ((back["port"], jeng), (back["jax"], teng)):
        assert isinstance(loaded.history, (RenderHistory, JaxRenderHistory))
        for a, b in zip(frame_triple(np.zeros(1), loaded.history)[1:],
                        frame_triple(np.zeros(1), src.history)[1:]):
            assert a.dtype == b.dtype == np.float16
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            ct.to_reference(loaded.state) if torch.is_tensor(loaded.state)
            else np.asarray(loaded.state), np.asarray(jeng.state))
        assert loaded.simulation_step == src.simulation_step
        np.testing.assert_array_equal(loaded.camera.prev_proj_view, src.camera.prev_proj_view)
    # The next frame from a copy of the saved engine, so the shared
    # fixture's engine is left as it was.
    again = ct.Engine.load(str(tmp_path / "port.npz"), device="cpu")
    saved = copy.deepcopy(teng)
    move(saved.camera, 7)
    move(again.camera, 7)
    np.testing.assert_array_equal(again.render().numpy(), saved.render().numpy())
    assert torch.equal(again.history.depth, saved.history.depth)


def test_history_round_trip_through_reference_form(clustered_engines):
    """``to_reference`` / ``from_reference`` carry a RenderHistory both ways."""
    _, teng, _ = clustered_engines
    pair = ct.to_reference(teng.history)
    assert [a.dtype for a in pair] == [np.float16, np.float16]
    back = ct.from_reference(JaxRenderHistory(*pair), device="cpu")
    assert isinstance(back, RenderHistory)
    assert torch.equal(back.color, teng.history.color)
    assert torch.equal(back.depth, teng.history.depth)
