"""The multi-state slice as a whole: ``cellularautomatons3d_tpu_torch.Engine``
on the CPU (plain torch twins of the kernels) against the JAX package's
``Engine`` (Pallas kernel in interpret mode) on three Generations presets at
32³ / 64×32, from a numpy-seeded block of random valid ages loaded into both
with ``set_state_dense``.

Contract: ``state_dense()`` equal after 10 steps; frames within rtol 3e-3 /
atol 3e-4; history ids equal.  The states are held for every preset; the
frames (``render``, then ``run_fused``) for ``pyroclastic``, since each
preset's state count costs the JAX Engine ~40 s per entry point.
"""

import numpy as np
import pytest
import torch

import cellularautomatons3d_tpu as jca

import cellularautomatons3d_tpu_torch as ct
from cellularautomatons3d_tpu_torch.ops import ca_step

from _torch_multistate_scene import one_torch_thread  # noqa: F401

CFG = dict(grid_size=32, width=64, height=32)
# preset → share of age-1 cells in the seeded block (each preset's rule
# needs its own density to be alive or still decaying after 10 steps).
PRESETS = {"amoeba-445": 0.1, "clouds-decay": 0.5, "pyroclastic": 0.2}


def seeded_ages(total_states, p_alive):
    rng = np.random.default_rng(1)
    ages = np.zeros((32,) * 3, np.uint8)
    dying = np.where(rng.random((16,) * 3) < 0.3, rng.integers(1, total_states, (16,) * 3), 0)
    ages[8:24, 8:24, 8:24] = np.where(rng.random((16,) * 3) < p_alive, 1, dying)
    return ages


def both_engines(preset):
    cfg = {**CFG, **ct.PRESETS[preset]}
    assert ct.PRESETS[preset] == jca.PRESETS[preset]
    jeng = jca.Engine(jca.EngineConfig(**cfg))
    teng = ct.Engine(ct.EngineConfig(**cfg), device="cpu")
    ages = seeded_ages(cfg["total_states"], PRESETS[preset])
    jeng.set_state_dense(ages)
    teng.set_state_dense(ages)
    return jeng, teng, ages


def assert_frame(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-3, atol=3e-4)


@pytest.mark.parametrize("preset", list(PRESETS))
def test_multistate_engine_state_matches_jax_engine(preset):
    jeng, teng, ages = both_engines(preset)
    spec = teng.spec
    assert teng.state.shape == (spec.age_bits, 1, 32, 32) and spec.total_states > 2
    np.testing.assert_array_equal(teng.state_dense(), ages)
    np.testing.assert_array_equal(ct.to_reference(teng.state), np.asarray(jeng.state))

    jeng.step(10)
    teng.step(10)
    np.testing.assert_array_equal(teng.state_dense(), jeng.state_dense())
    assert teng.state_dense().max() > 1  # dying cells are left
    assert teng.simulation_step == jeng.simulation_step == 10

    # set_state_dense(state_dense()) round-trips, and the JAX Engine's state
    # carries across through interop, both ways.
    state = teng.state.clone()
    teng.set_state_dense(teng.state_dense())
    assert torch.equal(teng.state, state)
    assert torch.equal(ct.from_reference(np.asarray(jeng.state), device="cpu"), state)
    words = ct.to_reference(state)
    assert words.dtype == np.uint32 and words.shape == tuple(state.shape)
    np.testing.assert_array_equal(words, np.asarray(jeng.state))
    assert torch.equal(teng._visibility_plane(), ca_step.age_masks(state)[1])


def test_multistate_engine_frames_match_jax_engine():
    jeng, teng, _ = both_engines("pyroclastic")
    jeng.step(10)
    teng.state = ct.from_reference(np.asarray(jeng.state), device="cpu")  # carried across
    assert_frame(teng.render(), jeng.render())
    np.testing.assert_array_equal(
        teng.history.hit_idx.numpy(), np.asarray(jeng.history.hit_idx))
    assert (teng.history.hit_idx >= 0).sum() > 20
    # Each fused frame blends the history of the one before, the first one
    # render()'s (JAX's interpret-mode kernel runs ~10-25 s a frame here).
    assert_frame(teng.run_fused(2), jeng.run_fused(2))
    np.testing.assert_array_equal(teng.state_dense(), jeng.state_dense())
    np.testing.assert_array_equal(
        teng.history.hit_idx.numpy(), np.asarray(jeng.history.hit_idx))


@pytest.mark.parametrize("total_states", range(3, 11))
def test_every_state_count_builds_steps_renders_and_fuses(total_states):
    eng = ct.Engine(ct.EngineConfig(**CFG, neighbourhood="moore", born="4-7",
                                    survive="3-6", total_states=total_states),
                    device="cpu")
    eng.set_state_dense(seeded_ages(total_states, 0.2))
    eng.step(3)
    frames = [eng.render(), eng.run_fused(2)]
    for f in frames:
        assert tuple(f.shape) == (32, 64, 3)
        assert bool(torch.isfinite(f).all()) and float(f.max()) > 0.0
    dense = eng.state_dense()
    assert dense.max() < total_states and (dense > 1).any()
    assert eng.simulation_step == 5


@pytest.mark.parametrize("overrides", [
    dict(soft_shadow_samples=4, indirect_lighting=True, light_radius=0.08),
    dict(soft_shadow_samples=4, indirect_lighting=True, light_radius=0.08, gi_temporal=True),
    dict(indirect_lighting=True, indirect_bounces=2),
    dict(grid_size=320),
], ids=["full_quality", "gi_temporal", "two_bounces", "sliced_320"])
def test_multistate_engine_in_every_lighting_mode(overrides):
    cfg = {**CFG, **ct.PRESETS["pyroclastic"], "random_initial_state": True, **overrides}
    eng = ct.Engine(ct.EngineConfig(**cfg), device="cpu")
    if cfg["grid_size"] == 32:
        eng.step(12)
    else:  # a 64³ block of random ages, large enough to span 64×32 pixels
        n = cfg["grid_size"]
        ages = np.zeros((n,) * 3, np.uint8)
        ages[128:192, 128:192, 128:192] = np.tile(seeded_ages(10, 0.2), (2, 2, 2))
        eng.set_state_dense(ages)
        eng.step(2)
    state = eng.state.clone()
    frames = [eng.render(), eng.render(), eng.run_fused(2, reset_every=2)]
    for f in frames:
        assert bool(torch.isfinite(f).all()) and float(f.max()) > 0.0
    assert torch.equal(eng.state, state)  # reset_every pinned the scene
    assert (eng.history.hit_idx >= 0).any()
