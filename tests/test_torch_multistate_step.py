"""The port's multi-state (Generations) CA step against the JAX package (CPU).

The same numpy-seeded age volumes go through ``cellularautomatons3d_tpu``
(JAX) and ``cellularautomatons3d_tpu_torch`` (the plain torch twin of the
multi-state step kernel, which CPU tensors take); packed states must be
bit-exact, and both must equal the two dense oracles on valid ages.  The JAX
step runs op by op (``jax.disable_jit``): at 32³ that is faster than one
compile per rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cellularautomatons3d_tpu.models.automaton import AutomatonSpec as JaxSpec
from cellularautomatons3d_tpu.ops import bitplane as jax_bitplane
from cellularautomatons3d_tpu.ops import ca_reference as jax_ref
from cellularautomatons3d_tpu.ops import ca_step as jax_ca
from cellularautomatons3d_tpu.ops.loop import make_multi_step as jax_multi_step
from cellularautomatons3d_tpu.types import BoundaryMode

import cellularautomatons3d_tpu_torch as ct
from cellularautomatons3d_tpu_torch.models.automaton import AutomatonSpec
from cellularautomatons3d_tpu_torch.ops import bitplane, ca_reference, ca_step
from cellularautomatons3d_tpu_torch.ops.loop import make_multi_step

import _torch_multistate_scene as scene
from _torch_multistate_scene import pack_ages

from _torch_multistate_scene import one_torch_thread  # noqa: F401

N = 32
NEIGHBOURHOODS = [
    "moore", "moore 2D", "von neumann", "von neumann 2D", "edges", "corners",
]
BOUNDARIES = [BoundaryMode.CLAMP_REF, BoundaryMode.WRAP, BoundaryMode.CLAMP]
STATES = [3, 5, 8, 10]
MIXED = dict(born_edges="2,5", survive_edges="3-6", born_corners="1",
             survive_corners="2-4")


def both_specs(**kw):
    return (JaxSpec.from_rule_strings(grid_size=N, **kw),
            AutomatonSpec.from_rule_strings(grid_size=N, **kw))


def random_ages(seed, total_states, p_dead=0.5):
    """Dense uint8 [N, N, N] of valid ages 0..S-1, cells on every face."""
    return scene.random_ages(N, total_states, seed, p_dead)


def run_all(ages, jspec, tspec, generations=6):
    """Packed JAX, packed torch, dense JAX and dense torch, in step."""
    planes = pack_ages(ages, tspec.age_bits)
    j, t = jnp.asarray(planes), ct.from_reference(planes)
    jd, td = jnp.asarray(ages), torch.from_numpy(ages)
    with jax.disable_jit():
        for g in range(generations):
            j = jax_ca.step_packed_multistate(j, jspec)
            t = ca_step.step_packed(t, tspec)
            jd = jax_ref.step_dense(jd, jspec)
            td = ca_reference.step_dense(td, tspec)
            msg = f"generation {g + 1}"
            np.testing.assert_array_equal(ct.to_reference(t), np.asarray(j), err_msg=msg)
            np.testing.assert_array_equal(td.numpy(), np.asarray(jd), err_msg=msg)
            assert torch.equal(ca_reference.planes_to_dense(t), td), msg
    return t, td


@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("neighbourhood", NEIGHBOURHOODS)
@pytest.mark.parametrize("total_states", STATES)
def test_multistate_step_matches_jax_and_dense(total_states, neighbourhood, boundary):
    jspec, tspec = both_specs(
        neighbourhood=neighbourhood, born="2,4", survive="1-4",
        total_states=total_states, boundary=boundary,
    )
    seed = (STATES.index(total_states) * 6 + NEIGHBOURHOODS.index(neighbourhood)) * 3 \
        + BOUNDARIES.index(boundary)
    _, dense = run_all(random_ages(seed, total_states), jspec, tspec)
    assert (dense > 0).any() and (dense == 0).any()  # the scene did not die out


@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_multistate_step_mixed_groups_matches_jax(boundary):
    jspec, tspec = both_specs(
        neighbourhood="von neumann", born="2", survive="1-3", total_states=6,
        boundary=boundary, **MIXED,
    )
    assert len(tspec.active_groups()) == 3
    run_all(random_ages(50 + BOUNDARIES.index(boundary), 6, p_dead=0.7), jspec, tspec)


@pytest.mark.parametrize("total_states", [3, 5, 6, 10])
def test_multistate_step_on_invalid_encodings_matches_jax(total_states):
    """Ages >= S never arise from valid states; the bit-sliced update still
    defines them (the ripple increment), and the port matches JAX's."""
    jspec, tspec = both_specs(neighbourhood="moore", born="4-9", survive="3-12",
                              total_states=total_states)
    rng = np.random.default_rng(total_states)
    planes = rng.integers(0, 2**32, (tspec.age_bits, N // 32, N, N), dtype=np.uint32)
    with jax.disable_jit():
        want = np.asarray(jax_ca.step_packed_multistate(jnp.asarray(planes), jspec))
    got = ca_step.step_packed_multistate(ct.from_reference(planes), tspec)
    np.testing.assert_array_equal(ct.to_reference(got), want)


def test_two_states_through_the_multistate_entry_is_the_binary_step():
    _, tspec = both_specs(total_states=2)
    rng = np.random.default_rng(2)
    packed = ct.from_reference(ct.pack_grid((rng.random((N, N, N)) < 0.2).astype(np.uint8)))
    got = ca_step.step_packed_multistate(packed[None], tspec)
    assert got.shape == (1,) + packed.shape
    assert torch.equal(got[0], ca_step.step_packed(packed, tspec))


def test_three_states_last_age_is_the_first_dying_age():
    """S = 3: start_dying (2) is also the last age, so 1 -> 2 -> 0."""
    _, tspec = both_specs(neighbourhood="moore", born="", survive="", total_states=3)
    ages = np.zeros((N, N, N), np.uint8)
    ages[5, 6, 7] = 1
    t = ct.from_reference(pack_ages(ages, 2))
    seen = []
    for _ in range(3):
        t = ca_step.step_packed(t, tspec)
        seen.append(int(ca_reference.planes_to_dense(t)[5, 6, 7]))
    assert seen == [2, 0, 0]


@pytest.mark.parametrize("total_states", [2, 5])
def test_make_multi_step_equals_single_steps_and_jax(total_states):
    jspec, tspec = both_specs(neighbourhood="moore", born="4", survive="3-5",
                              total_states=total_states)
    ages = random_ages(7, total_states, p_dead=0.7)
    state = pack_ages(ages, tspec.age_bits) if total_states > 2 else ct.pack_grid(ages)
    start = ct.from_reference(state)
    got = make_multi_step(tspec, 4)(start)
    want = start
    for _ in range(4):
        want = ca_step.step_packed(want, tspec)
    assert torch.equal(got, want)
    assert torch.equal(start, ct.from_reference(state))  # the input is not modified
    with jax.disable_jit():
        ref = jax_multi_step(jspec, 4)(jnp.asarray(state))
    np.testing.assert_array_equal(ct.to_reference(got), np.asarray(ref))


def test_make_step_fn_dispatches_by_total_states():
    _, binary = both_specs()
    _, multi = both_specs(total_states=5)
    planes = ct.from_reference(pack_ages(random_ages(3, 5), multi.age_bits))
    assert torch.equal(ct.make_step_fn(multi)(planes),
                       ca_step.step_packed_multistate(planes, multi))
    assert torch.equal(ct.make_step_fn(binary)(planes[0]),
                       ca_step.fires_plane(planes[0], binary))
    with pytest.raises(ValueError, match="age planes"):
        ca_step.step_packed(planes[:2], multi)  # 2 planes cannot hold 5 states
    # A non-CPU tensor takes the kernels, which raise here: nothing falls back.
    with pytest.raises((ValueError, RuntimeError)):
        ca_step.step_packed(planes.to("meta"), multi)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ca_step.step_packed_multistate_cuda(planes, multi)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ca_step.age_masks_cuda(planes)
    assert ca_step.step_packed_multistate_cuda.launches == 0
    assert ca_step.age_masks_cuda.launches == 0


def test_visibility_and_alive_planes():
    _, multi = both_specs(total_states=10)
    ages = random_ages(4, 10)
    planes = ct.from_reference(pack_ages(ages, 4))
    alive, vis = ca_step.age_masks(planes)
    np.testing.assert_array_equal(ct.unpack_grid(ct.to_reference(alive)), ages == 1)
    np.testing.assert_array_equal(ct.unpack_grid(ct.to_reference(vis)), ages > 0)
    assert torch.equal(ca_step.visibility_plane(planes, multi), vis)
    _, binary = both_specs()
    plane = planes[0]
    assert ca_step.visibility_plane(plane, binary) is plane  # a binary state is its own


def test_dense_plane_converters_match_the_host_packing():
    ages = random_ages(9, 10)
    planes = ca_reference.dense_to_planes(torch.from_numpy(ages), 4)
    np.testing.assert_array_equal(ct.to_reference(planes), pack_ages(ages, 4))
    np.testing.assert_array_equal(ca_reference.planes_to_dense(planes).numpy(), ages)


@pytest.mark.parametrize("offset", [(1, -1, 1), (-1, 1, -1), (3, 0, 0), (-5, 2, -2)])
@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_shift_and_count_dense_match_jax(offset, boundary):
    ages = random_ages(11, 2, p_dead=0.6)
    want = np.asarray(jax_ref.shift_dense(jnp.asarray(ages), offset, boundary))
    got = ca_reference.shift_dense(torch.from_numpy(ages), offset, boundary)
    np.testing.assert_array_equal(got.numpy(), want)
    offs = [offset, tuple(-c for c in offset)]
    want = np.asarray(jax_ref.count_neighbours_dense(jnp.asarray(ages), offs, boundary))
    got = ca_reference.count_neighbours_dense(torch.from_numpy(ages), offs, boundary)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32


def test_run_dense_matches_jax():
    jspec, tspec = both_specs(neighbourhood="moore", born="4", survive="3-5", total_states=5)
    ages = random_ages(13, 5, p_dead=0.7)
    with jax.disable_jit():
        want = np.asarray(jax_ref.run_dense(jnp.asarray(ages), jspec, 3))
    np.testing.assert_array_equal(
        ca_reference.run_dense(torch.from_numpy(ages), tspec, 3).numpy(), want)


def _random_words(seed, k, shape=(4, 8, 16)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 2**32, shape, dtype=np.uint32) for _ in range(k)]


def _to_torch(words):
    return [ct.from_reference(w) for w in words]


def test_bitplane_select_and_increment_match_jax():
    a, b, (m,) = _random_words(1, 4), _random_words(2, 3), _random_words(3, 1)
    want = jax_bitplane.select_planes(jnp.asarray(m), [jnp.asarray(x) for x in a],
                                      [jnp.asarray(x) for x in b])
    got = bitplane.select_planes(ct.from_reference(m), _to_torch(a), _to_torch(b))
    assert len(got) == len(want) == 4  # the shorter list is zero-padded
    for g, w in zip(got, want):
        np.testing.assert_array_equal(ct.to_reference(g), np.asarray(w))
    want = jax_bitplane.increment_planes([jnp.asarray(x) for x in a])
    for g, w in zip(bitplane.increment_planes(_to_torch(a)), want):
        np.testing.assert_array_equal(ct.to_reference(g), np.asarray(w))


def test_bitplane_int_conversions_match_jax_and_round_trip():
    planes = _random_words(4, 4)
    want = np.asarray(jax_bitplane.planes_to_int([jnp.asarray(p) for p in planes]))
    got = bitplane.planes_to_int(_to_torch(planes))
    assert got.shape == (32,) + planes[0].shape and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    back = bitplane.int_to_planes(got, 4)
    want_back = jax_bitplane.int_to_planes(jnp.asarray(want), 4)
    for g, w, p in zip(back, want_back, planes):
        np.testing.assert_array_equal(ct.to_reference(g), np.asarray(w))
        np.testing.assert_array_equal(ct.to_reference(g), p)
    # increment_planes is +1 on the encoded values (mod 16).
    inc = bitplane.planes_to_int(bitplane.increment_planes(_to_torch(planes)))
    assert torch.equal(inc, (got + 1) % 16)
