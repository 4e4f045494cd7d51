"""The port's CA step and occupancy mip against the JAX package (CPU).

The same numpy-seeded states go through ``cellularautomatons3d_tpu``
(JAX) and ``cellularautomatons3d_tpu_torch`` (the plain torch twin of the
CUDA step kernel, which CPU tensors take); results must be bit-exact.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cellularautomatons3d_tpu.models.automaton import AutomatonSpec as JaxSpec
from cellularautomatons3d_tpu.ops import ca_step as jax_ca
from cellularautomatons3d_tpu.ops.occupancy import coarse_occupancy as jax_coarse
from cellularautomatons3d_tpu.types import BoundaryMode

import cellularautomatons3d_tpu_torch as ct
from cellularautomatons3d_tpu_torch.models.automaton import AutomatonSpec
from cellularautomatons3d_tpu_torch.ops import ca_step
from cellularautomatons3d_tpu_torch.ops.occupancy import coarse_occupancy

N = 32
NEIGHBOURHOODS = [
    "moore", "moore 2D", "von neumann", "von neumann 2D", "edges", "corners",
]
BOUNDARIES = [BoundaryMode.CLAMP_REF, BoundaryMode.WRAP, BoundaryMode.CLAMP]
# Non-default edge/corner groups (tests/test_multigroup.py style): all three
# rule groups are active and OR together.
MIXED = dict(born_edges="2,5", survive_edges="3-6", born_corners="1",
             survive_corners="2-4")


def random_packed(seed, p=0.2, n=N):
    rng = np.random.default_rng(seed)
    dense = (rng.random((n, n, n)) < p).astype(np.uint8)
    return ct.pack_grid(dense)


def both_specs(**kw):
    return (
        JaxSpec.from_rule_strings(grid_size=N, **kw),
        AutomatonSpec.from_rule_strings(grid_size=N, **kw),
    )


def run_both(packed, jspec, tspec, generations=3):
    j = jnp.asarray(packed)
    t = ct.from_reference(packed, device="cpu")
    for g in range(generations):
        j = jax_ca.step_packed(j, jspec)
        t = ca_step.step_packed(t, tspec)
        np.testing.assert_array_equal(
            ct.to_reference(t), np.asarray(j), err_msg=f"generation {g + 1}"
        )
    return t


@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("neighbourhood", NEIGHBOURHOODS)
def test_step_matches_jax(neighbourhood, boundary):
    jspec, tspec = both_specs(
        neighbourhood=neighbourhood, born="1,3", survive="0-6",
        boundary=boundary,
    )
    seed = NEIGHBOURHOODS.index(neighbourhood) * 3 + BOUNDARIES.index(boundary)
    run_both(random_packed(seed), jspec, tspec)


@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_step_mixed_groups_matches_jax(boundary):
    jspec, tspec = both_specs(
        neighbourhood="von neumann", born="2", survive="1-3",
        boundary=boundary, **MIXED,
    )
    assert len(tspec.active_groups()) == 3
    run_both(random_packed(40 + BOUNDARIES.index(boundary), p=0.3), jspec, tspec)


def test_seed_center_population_seven():
    """Default rule (vN B1,3/S0-6): one cell becomes itself + 6 faces."""
    tspec = AutomatonSpec.from_rule_strings(grid_size=N)
    packed = ct.from_reference(ct.pack_grid(ct.seed_center(N)), device="cpu")
    packed = ca_step.step_packed(packed, tspec)
    assert ct.unpack_grid(ct.to_reference(packed)).sum() == 7


@pytest.mark.parametrize("offset", [(1, -1, 1), (-1, 1, -1), (3, 0, 0), (-5, 2, -2)])
@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_shift_packed_matches_jax(offset, boundary):
    packed = random_packed(7, p=0.4)
    want = np.asarray(jax_ca.shift_packed(jnp.asarray(packed), offset, boundary))
    got = ca_step.shift_packed(ct.from_reference(packed, device="cpu"), offset, boundary)
    np.testing.assert_array_equal(ct.to_reference(got), want)


def sparse_packed(seed, n, count=4000):
    """Packed words [n/32, n, n] with ``count`` random words set anywhere
    and one bit in the last x-word (a partial last x-group above 256)."""
    rng = np.random.default_rng(seed)
    words = np.zeros((n // 32, n, n), np.uint32)
    at = tuple(rng.integers(0, s, count) for s in words.shape)
    words[at] = rng.integers(1, 2**32, count, dtype=np.uint64).astype(np.uint32)
    words[-1, n - 3, 5] = np.uint32(1 << 31)
    return words


# p: the cells' density of a dense random grid; None: sparse random words
# (256: one full x-group, 480: a partial second one, 512: two).
@pytest.mark.parametrize("n,p", [(32, 0.01), (64, 0.002), (96, 0.001), (320, 0.0002),
                                 (256, None), (480, None), (512, None)])
def test_coarse_occupancy_matches_jax(n, p):
    packed = random_packed(11, p=p, n=n) if p is not None else sparse_packed(n, n)
    want = np.asarray(jax_coarse(jnp.asarray(packed)))
    got = coarse_occupancy(ct.from_reference(packed, device="cpu"))
    np.testing.assert_array_equal(ct.to_reference(got), want)


def test_step_fn_and_multistate_guard():
    tspec = AutomatonSpec.from_rule_strings(grid_size=N)
    step = ct.make_step_fn(tspec)
    packed = ct.from_reference(random_packed(3), device="cpu")
    assert torch.equal(step(packed), ca_step.step_packed(packed, tspec))
    # A multi-state spec steps age planes [B, W, Z, Y] and refuses a binary
    # state (tests/test_torch_multistate_step.py holds it against JAX).
    multi = AutomatonSpec.from_rule_strings(grid_size=N, total_states=5)
    planes = torch.stack([packed, torch.zeros_like(packed), torch.zeros_like(packed)])
    assert torch.equal(ct.make_step_fn(multi)(planes),
                       ca_step.step_packed_multistate(planes, multi))
    with pytest.raises(ValueError, match="age planes"):
        ct.make_step_fn(multi)(packed)


@pytest.mark.parametrize("n, chunk", [(32, 1), (64, 1), (96, 1), (256, 3), (512, 16), (1024, 32)])
def test_step_kernel_plan(n, chunk):
    """The CUDA step's launch plan: a halo of 1 for every neighbourhood and
    mixed groups, and rows of w per block chosen so that about 4 blocks per
    SM run; the chunks cover W (at 256³ the last one is partial)."""
    for neighbourhood in NEIGHBOURHOODS:
        spec = AutomatonSpec.from_rule_strings(grid_size=n, neighbourhood=neighbourhood, **MIXED)
        assert ca_step._step_plan(spec) == (1, chunk)
    w = n // 32
    blocks = -(-w // chunk) * (n // 32) * (n // 8)
    assert 1 <= chunk <= w and (chunk == 1 or blocks >= ca_step._TARGET_BLOCKS or chunk == w)


def test_step_kernel_plan_halo_and_refusal():
    """The halo follows the widest |dy| or |dz|; |dx| does not widen it
    (a funnel shift reaches 31 cells).  Offsets beyond ±31 are refused
    with a clear error, not sent elsewhere; the plain step takes them."""
    import dataclasses

    spec = AutomatonSpec.from_rule_strings(grid_size=64)
    wide = dataclasses.replace(spec, offsets_main=((0, 2, 0), (0, 0, -3), (31, 0, 0), (-5, 1, 1)))
    assert ca_step._step_plan(wide) == (3, 1)
    empty = AutomatonSpec.from_rule_strings(grid_size=64, born="", survive="")
    assert ca_step._step_plan(empty) == (0, 1)
    too_wide = dataclasses.replace(spec, offsets_main=((0, 0, 1), (0, 40, 0)))
    with pytest.raises(ValueError, match="±31"):
        ca_step._step_plan(too_wide)
    state = ct.from_reference(random_packed(4, n=64), device="cpu")
    assert ca_step.fires_plane(state, too_wide).shape == state.shape
