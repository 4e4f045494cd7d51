"""K1 with age planes: the port's plain torch twin of ``csrc/render_fast.cu``
against the JAX package's Pallas kernel in interpret mode on a Generations
scene (random valid ages of an 8-state rule at 32³ / 128×64), and the
known-answer age fade.

Contract: hit ids equal, depth within atol 3e-5, rgb within rtol 3e-3 / atol
3e-4 (tests/test_torch_render_fast.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cellularautomatons3d_tpu.ops.occupancy import coarse_occupancy as jax_coarse
from cellularautomatons3d_tpu.render import render_fast as jrf

import cellularautomatons3d_tpu_torch as ct
from cellularautomatons3d_tpu_torch.ops.occupancy import coarse_occupancy
from cellularautomatons3d_tpu_torch.render import render_fast as trf
from cellularautomatons3d_tpu_torch.render import render_slab

from _torch_multistate_scene import hit_ages, pack_ages, random_ages, visibility
from test_torch_render_fast import H, N, W, assert_contract, cam_for

from _torch_multistate_scene import one_torch_thread  # noqa: F401

S = 8  # total states: 3 age planes


def scene(seed=5, p_dead=0.95):
    ages = random_ages(N, S, seed, p_dead)
    planes = pack_ages(ages, 3)
    return ages, planes, visibility(planes)


def run_jax(planes, vis, cam, shadow, history=None):
    vol, ages = jnp.asarray(vis), jnp.asarray(planes)
    kw = dict(grid_size=N, width=W, height=H, shadow=shadow, interpret=True,
              total_states=S)
    if history is None:
        out = jrf.raytrace_tiles(vol, jax_coarse(vol), jnp.asarray(cam), ages, **kw)
        return tuple(np.asarray(o) for o in out)
    color, hidx = history
    blk = tuple(jrf._to_blocks(jnp.asarray(color[..., c]), W, H) for c in range(3))
    blk += (jrf._to_blocks(jnp.asarray(hidx), W, H, fill=-1),)
    outs = jrf.raytrace_tiles(vol, jax_coarse(vol), jnp.asarray(cam), ages, blk, **kw)
    img = [np.asarray(jrf._from_blocks(o, W, H)) for o in outs]
    return np.stack(img[0:3], axis=-1), img[3], img[4], np.stack(img[5:8], axis=-1)


def run_torch(planes, vis, cam, shadow, history=None, with_ages=True):
    vol = ct.from_reference(vis)
    hist = None
    if history is not None:
        hist = (torch.from_numpy(history[0]), torch.from_numpy(history[1]))
    kw = dict(ages=ct.from_reference(planes), total_states=S) if with_ages else {}
    outs = trf.raytrace_tiles(vol, coarse_occupancy(vol), cam, hist, grid_size=N,
                              width=W, height=H, shadow=shadow, **kw)
    return tuple(o.numpy() for o in outs)


@pytest.mark.parametrize("shadow", [True, False])
def test_plain_k1_with_ages_matches_jax(shadow):
    ages, planes, vis = scene()
    cam = cam_for()
    want = run_jax(planes, vis, cam, shadow)
    got = run_torch(planes, vis, cam, shadow)
    assert (want[2] >= 0).mean() > 0.2  # the scene is actually hit
    assert_contract(got, want)
    # Every age 1..S-1 is among the hit cells, and the dying ones are dimmer
    # than in the binary frame of the same visibility plane.
    hit_age = hit_ages(ages, got[2])
    assert set(np.unique(hit_age[got[2] >= 0])) == set(range(1, S))
    binary = run_torch(planes, vis, cam, shadow, with_ages=False)
    np.testing.assert_array_equal(binary[2], got[2])
    dying = (got[2] >= 0) & (hit_age > 1)
    assert (got[0][dying] <= binary[0][dying]).all()
    assert (got[0][dying] < binary[0][dying]).any()
    np.testing.assert_array_equal(got[0][~dying], binary[0][~dying])


def test_plain_k1_compose_with_ages_matches_jax():
    """Compose mode over a non-trivial history; the emissive term is added
    unfaded to every hit."""
    _, planes, vis = scene(seed=9)
    cam = cam_for(emissive_color=(0.02, 0.03, 0.04), emissive_strength=0.5)
    rgb0, _, idx0 = run_torch(planes, vis, cam_for(), True)
    rng = np.random.default_rng(1)
    hidx = np.where(rng.random(idx0.shape) < 0.3, idx0 + 1, idx0).astype(np.int32)
    hcolor = np.clip(rgb0 * 1.7 + 0.05, 0.0, 1.0).astype(np.float32)
    want = run_jax(planes, vis, cam, True, (hcolor, hidx))
    got = run_torch(planes, vis, cam, True, (hcolor, hidx))
    same = (want[2] == hidx) & (want[2] >= 0)
    assert same.any() and (~same & (want[2] >= 0)).any()
    assert_contract(got, want)
    np.testing.assert_allclose(got[3], want[3], rtol=3e-3, atol=3e-4)


def _wall(age):
    dense = np.zeros((N, N, N), np.uint8)
    dense[20, 12:20, 12:20] = age
    return dense


def test_age_fade_known_answer():
    """tests/test_render_fast.py::test_fast_age_coloring, exactly: a wall at
    age 6 of 8 shows 2/7 of its age-1 colour (one f32 product per channel),
    and at age 1 the binary frame."""
    cam = cam_for()
    frames = {}
    for age in (1, 6):
        planes = pack_ages(_wall(age), 3)
        frames[age] = run_torch(planes, visibility(planes), cam, False)
    planes = pack_ages(_wall(1), 3)
    binary = run_torch(planes, visibility(planes), cam, False, with_ages=False)
    np.testing.assert_array_equal(frames[1][0], binary[0])
    np.testing.assert_array_equal(frames[6][2], frames[1][2])
    hit = frames[1][0].sum(-1) > 0
    assert hit.sum() > 100
    fade = np.float32(2.0) / np.float32(7.0)
    np.testing.assert_array_equal(frames[6][0], frames[1][0] * fade)
    ratio = frames[6][0][hit].sum() / frames[1][0][hit].sum()
    assert 0.2 < ratio < 0.4


def test_age_fade_clips_and_emissive_is_not_faded():
    """The oldest age of a 3-state rule fades to 1/2; an (invalid) age >= S
    clips to 0, leaving only the emissive term in compose mode."""
    fade = trf._age_fade(torch.tensor([1, 2, 3, 7], dtype=torch.int32), 3)
    assert fade.tolist() == [1.0, 0.5, 0.0, 0.0]
    dense = _wall(3)
    planes = pack_ages(dense, 2)  # age 3 in 2 planes: invalid for S = 3
    vol = ct.from_reference(visibility(planes))
    cam = cam_for(emissive_color=(0.02, 0.03, 0.04), emissive_strength=0.5)
    hist = (torch.zeros((H, W, 3)), torch.full((H, W), -1, dtype=torch.int32))
    _, _, idx, light = trf.raytrace(
        vol, coarse_occupancy(vol), cam, hist, grid_size=N, width=W, height=H,
        shadow=False, ages=ct.from_reference(planes), total_states=3)
    hit = idx >= 0
    assert hit.sum() > 100
    want = torch.tensor([0.02, 0.03, 0.04]) * 0.5
    torch.testing.assert_close(light[hit], want.expand(int(hit.sum()), 3), rtol=0, atol=1e-7)


def test_plain_k4_age_output_is_the_hit_cells_age():
    ages, planes, vis = scene(seed=3, p_dead=0.97)
    cam = cam_for()
    kw = dict(grid_size=N, width=W, height=H)
    t, idx, age = render_slab.primary_sweep(
        ct.from_reference(vis), cam, ct.from_reference(planes), **kw)
    t_b, idx_b = render_slab.primary_sweep(ct.from_reference(vis), cam, **kw)
    assert torch.equal(idx, idx_b) and torch.equal(t, t_b)
    assert age.dtype == torch.int32
    np.testing.assert_array_equal(age.numpy(), hit_ages(ages, idx.numpy()))
    assert (idx >= 0).sum() > 500 and (age[idx < 0] == 1).all()


def test_ages_are_validated_and_never_fall_back():
    _, planes, vis = scene()
    vol, ages = ct.from_reference(vis), ct.from_reference(planes)
    kw = dict(grid_size=N, width=W, height=H)
    with pytest.raises(ValueError, match="age planes"):
        trf.raytrace(vol, coarse_occupancy(vol), cam_for(), ages=ages[0], total_states=S, **kw)
    with pytest.raises(ValueError, match="CUDA tensor"):
        trf.raytrace_cuda(vol, coarse_occupancy(vol), cam_for(), ages=ages,
                          total_states=S, **kw)
    with pytest.raises(ValueError, match="CUDA tensor"):
        render_slab.primary_sweep_cuda(vol, coarse_occupancy(vol), cam_for(), ages, **kw)
    with pytest.raises((ValueError, RuntimeError)):
        trf.raytrace_tiles(vol.to("meta"), coarse_occupancy(vol).to("meta"), cam_for(),
                           ages=ages.to("meta"), total_states=S, **kw)
    assert trf.raytrace_cuda.launches == 0
    assert render_slab.primary_sweep_cuda.launches == 0
