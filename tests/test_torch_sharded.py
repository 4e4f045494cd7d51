"""The port's sharded CA step (``parallel.sharded``) against the JAX
package's ``make_sharded_step`` on the 8 virtual CPU devices of
``tests/conftest.py``, bit for bit: the cases of ``tests/test_sharded.py``
(1-D meshes of 8 and 4 shards and 2-D ``(4, 2)`` / ``(2, 4)`` meshes in every
boundary mode, several generations, multi-state rules, the validation
errors), plus the thinnest shards the checks admit and the halo-exchange
functions on explicit neighbour tensors.  The port's shards live on the CPU
(``devices=["cpu"] * k``), where each shard steps through the slab kernel's
plain twin; ``tests/test_torch_cuda.py`` holds the kernel to the twin."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cellularautomatons3d_tpu.models.automaton import AutomatonSpec as JaxSpec
from cellularautomatons3d_tpu.parallel import sharded as jsh

import cellularautomatons3d_tpu_torch as ct
from cellularautomatons3d_tpu_torch.ops import ca_step
from cellularautomatons3d_tpu_torch.parallel import sharded as tsh

N = 32
RULE = dict(neighbourhood="moore", born="4,5", survive="2-6")


def random_words(spec, seed, p=0.3):
    """Packed words (or age planes) of a random grid, numpy uint32."""
    rng = np.random.default_rng(seed)
    n = spec.grid_size
    if spec.total_states == 2:
        return ct.pack_grid((rng.random((n, n, n)) < p).astype(np.uint8))
    ages = rng.integers(0, spec.total_states, size=(n, n, n)).astype(np.uint8)
    return np.stack([ct.pack_grid((ages >> i) & 1) for i in range(spec.age_bits)])


def specs(**kw):
    """The same automaton in both packages."""
    return (JaxSpec.from_rule_strings(grid_size=N, **kw),
            ct.AutomatonSpec.from_rule_strings(grid_size=N, **kw))


def jax_steps(spec, words, steps, n_devices=None, shape=None):
    mesh = jsh.make_mesh(n_devices, shape=shape)
    step = jsh.make_sharded_step(spec, mesh)
    state = jsh.shard_state(jnp.asarray(words), mesh)
    for _ in range(steps):
        state = step(state)
    return np.asarray(state)


def port_steps(spec, words, steps, n_devices=None, shape=None):
    k = n_devices if shape is None else shape[0] * shape[1]
    mesh = tsh.make_mesh(n_devices, devices=["cpu"] * k, shape=shape)
    step = tsh.make_sharded_step(spec, mesh)
    state = tsh.shard_state(ct.from_reference(words, device="cpu"), mesh)
    for _ in range(steps):
        state = step(state)
    return state


def assert_matches_jax(jspec, tspec, words, steps=1, n_devices=None, shape=None):
    """Port == JAX on the same mesh, and == the port's single-device step."""
    got = port_steps(tspec, words, steps, n_devices, shape)
    want = jax_steps(jspec, words, steps, n_devices, shape)
    np.testing.assert_array_equal(ct.to_reference(got), want)
    ref = ct.from_reference(words, device="cpu")
    for _ in range(steps):
        ref = ca_step.step_packed(ref, tspec)
    assert torch.equal(got.full(), ref)
    return got


def test_conftest_gives_eight_devices():
    assert jax.device_count() >= 8


# ------------------------------------------------------------ 1-D mesh --
@pytest.mark.parametrize("n_devices", [8, 4])
@pytest.mark.parametrize("boundary", ct.BoundaryMode.ALL)
def test_sharded_step_matches_jax(n_devices, boundary):
    jspec, tspec = specs(boundary=boundary, **RULE)
    words = random_words(tspec, seed=len(boundary) + n_devices)
    assert_matches_jax(jspec, tspec, words, n_devices=n_devices)


def test_sharded_step_multiple_generations():
    """8 generations from one live cell: growth crosses the 4-plane shards."""
    jspec, tspec = specs()
    dense = np.zeros((N, N, N), np.uint8)
    dense[N // 2 - 1, N // 2 - 1, N // 2 - 1] = 1
    got = assert_matches_jax(jspec, tspec, ct.pack_grid(dense), steps=8, n_devices=8)
    assert ct.unpack_grid(ct.to_reference(got)).sum() > 100


def test_sharded_multistate():
    jspec, tspec = specs(neighbourhood="moore", born="4", survive="4", total_states=5)
    assert_matches_jax(jspec, tspec, random_words(tspec, seed=3), steps=2, n_devices=8)


# ------------------------------------------------------- 2-D (z, y) mesh --
@pytest.mark.parametrize("shape", [(4, 2), (2, 4)])
@pytest.mark.parametrize("boundary", ct.BoundaryMode.ALL)
def test_sharded_2d_step_matches_jax(shape, boundary):
    """Moore rules need the corner ribbons the y exchange carries from the
    z-padded columns."""
    jspec, tspec = specs(boundary=boundary, **RULE)
    words = random_words(tspec, seed=len(boundary) + shape[0])
    assert_matches_jax(jspec, tspec, words, steps=2, shape=shape)


def test_sharded_2d_multistate_generations():
    jspec, tspec = specs(neighbourhood="moore", born="4", survive="4", total_states=5)
    assert_matches_jax(jspec, tspec, random_words(tspec, seed=7), steps=4, shape=(2, 2))


def test_sharded_wide_y_offsets_match_jax():
    """An offset of |dy| = 3 (the checks admit any |dy|): on a 1-D mesh y is
    whole and the step equals the single-device one; on a 2-D mesh both
    packages shift the one-column-padded slab, so they agree with each other
    and not with the single-device step."""
    kw = dict(born="1,3", survive="1-2", boundary=ct.BoundaryMode.CLAMP_REF)
    jspec, tspec = specs(**kw)
    offs = ((0, 3, 0), (0, -3, 1), (1, 1, -1), (-2, 0, 0))
    jspec = dataclasses.replace(jspec, offsets_main=offs)
    tspec = dataclasses.replace(tspec, offsets_main=offs)
    words = random_words(tspec, seed=11, p=0.2)
    assert_matches_jax(jspec, tspec, words, steps=2, n_devices=8)
    got = port_steps(tspec, words, 1, shape=(4, 2))
    np.testing.assert_array_equal(ct.to_reference(got), jax_steps(jspec, words, 1, shape=(4, 2)))


@pytest.mark.parametrize("shape,states", [((32, 1), 2), ((2, 16), 2), ((32, 1), 5), ((2, 16), 5)])
def test_thinnest_shards(shape, states):
    """The thinnest shards the checks admit, beyond the 8 devices JAX has
    here: one z plane per shard, and y shards of 2 columns, against the
    single-device step in every boundary mode."""
    for boundary in ct.BoundaryMode.ALL:
        spec = ct.AutomatonSpec.from_rule_strings(N, boundary=boundary, total_states=states,
                                                  **RULE)
        words = random_words(spec, seed=shape[0] + states)
        got = port_steps(spec, words, 2, shape=shape)
        ref = ct.from_reference(words, device="cpu")
        for _ in range(2):
            ref = ca_step.step_packed(ref, spec)
        assert torch.equal(got.full(), ref), boundary


# ------------------------------------------------------------ validation --
def test_validation_errors():
    jspec, tspec = specs()
    cpu = ["cpu"] * 8
    with pytest.raises(ValueError):
        jsh.make_sharded_step(jspec, jsh.make_mesh(3))
    with pytest.raises(ValueError, match="not divisible"):
        tsh.make_sharded_step(tspec, tsh.make_mesh(3, devices=cpu))
    with pytest.raises(ValueError):
        jsh.make_sharded_step(jspec, jsh.make_mesh(shape=(1, 3)))
    with pytest.raises(ValueError, match="not divisible"):
        tsh.make_sharded_step(tspec, tsh.make_mesh(shape=(1, 3), devices=cpu))
    with pytest.raises(ValueError, match="2 cell columns"):
        tsh.make_sharded_step(tspec, tsh.make_mesh(shape=(1, 32), devices=["cpu"] * 32))
    deep = ((0, 0, 2),)
    with pytest.raises(NotImplementedError, match="dz"):
        jsh.make_sharded_step(dataclasses.replace(jspec, offsets_main=deep), jsh.make_mesh(8))
    with pytest.raises(NotImplementedError, match="dz"):
        tsh.make_sharded_step(dataclasses.replace(tspec, offsets_main=deep),
                              tsh.make_mesh(8, devices=cpu))
    with pytest.raises(ValueError):
        jsh.make_mesh(shape=(16, 16))
    with pytest.raises(ValueError, match="needs 256 devices, have 8"):
        tsh.make_mesh(shape=(16, 16), devices=cpu)
    with pytest.raises(ValueError, match="unknown boundary"):
        tsh.halo_exchange_z([torch.zeros(1, 2, 32, dtype=torch.int32)], "mirror")


def test_make_mesh(monkeypatch):
    """Devices: repeats allowed, the first n taken, too few raise with the
    count (JAX would shrink a 1-D mesh); by default the CUDA devices."""
    mesh = tsh.make_mesh(4, devices=["cpu"] * 6)
    assert mesh.shape == {"z": 4} and mesh.size == 4 and mesh.axis_names == ("z",)
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    mesh2 = tsh.make_mesh(shape=(2, 3), devices=["cpu"] * 6)
    assert mesh2.shape == {"z": 2, "y": 3} and mesh2.devices.shape == (2, 3)
    assert tsh.make_mesh(devices=["cpu"] * 3).shape == {"z": 3}
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert [str(d) for d in tsh.make_mesh(1).devices.flat] == ["cuda:0"]
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        tsh.make_mesh(2)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="have 0 .no CUDA device"):
        tsh.make_mesh(2)


@pytest.mark.parametrize("shape,state_ndim", [((4,), 3), ((2, 2), 3), ((2, 2), 4)])
def test_sharded_layout(shape, state_ndim):
    """shard_state / shard_rows split as JAX's NamedSharding places shards
    (z, then y; rows over every mesh axis in row-major order) and ``full``
    gathers them back."""
    k = int(np.prod(shape))
    mesh = tsh.make_mesh(shape[0] if len(shape) == 1 else None, devices=["cpu"] * k,
                         shape=shape if len(shape) == 2 else None)
    g = torch.Generator().manual_seed(k)
    state = torch.randint(-2**31, 2**31 - 1, (3, 2, 8, 8)[4 - state_ndim:], dtype=torch.int32,
                          generator=g)
    sh = tsh.shard_state(state, mesh)
    assert sh.shape == tuple(state.shape) and torch.equal(sh.full(), state)
    z = state_ndim - 2
    for pos in np.ndindex(mesh.devices.shape):
        lz = 8 // shape[0]
        want = state.narrow(z, pos[0] * lz, lz)
        if len(shape) == 2:
            want = want.narrow(z + 1, pos[1] * (8 // shape[1]), 8 // shape[1])
        assert torch.equal(sh.shards[pos], want)
    rows = torch.arange(16 * 3, dtype=torch.float32).reshape(16, 3)
    hr = tsh.shard_rows(rows, mesh)
    for flat, pos in enumerate(np.ndindex(mesh.devices.shape)):
        assert torch.equal(hr.shards[pos], rows[flat * 16 // k:(flat + 1) * 16 // k])
    assert torch.equal(hr.full("cpu"), rows)


# ------------------------------------------------- the halo exchange --
def _slabs(k, w=1, z=2, y=32, base=0):
    """k slabs [w, z, y] whose every word names its shard, plane and column."""
    return [torch.arange(w * z * y, dtype=torch.int32).reshape(w, z, y) + 1000 * (i + 1) + base
            for i in range(k)]


@pytest.mark.parametrize("boundary", ct.BoundaryMode.ALL)
def test_halo_exchange_z(boundary):
    ring = _slabs(4)
    halos = tsh.halo_exchange_z(ring, boundary)
    for i, (lo, hi) in enumerate(halos):
        assert lo.shape == hi.shape == (1, 1, 32)
        want_lo = ring[(i - 1) % 4][:, -1:, :]
        want_hi = ring[(i + 1) % 4][:, :1, :]
        if i == 0 and boundary != ct.BoundaryMode.WRAP:
            want_lo = torch.zeros_like(want_lo)
        if i == 3 and boundary == ct.BoundaryMode.CLAMP:
            want_hi = torch.zeros_like(want_hi)
        assert torch.equal(lo, want_lo) and torch.equal(hi, want_hi)
    # A ring of one is its own neighbour (JAX's self-ring).
    (lo, hi), = tsh.halo_exchange_z(ring[:1], ct.BoundaryMode.WRAP)
    assert torch.equal(lo, ring[0][:, -1:]) and torch.equal(hi, ring[0][:, :1])


@pytest.mark.parametrize("boundary", ct.BoundaryMode.ALL)
def test_halo_exchange_y_carries_corner_ribbons(boundary):
    """The y halo is the neighbour's column of its z-padded slab: its first
    and last words are the neighbour's z halos (the corner ribbons), and it
    matches JAX's concatenation of the padded slab."""
    ring = _slabs(3, w=2, z=3, y=4)
    z_halos = [(torch.full((2, 1, 4), -(j + 1), dtype=torch.int32),
                torch.full((2, 1, 4), -(j + 11), dtype=torch.int32)) for j in range(3)]
    halos = tsh.halo_exchange_y(ring, z_halos, boundary)
    padded = [ca_step.pad_slab(s, h) for s, h in zip(ring, z_halos)]
    for j, (lo, hi) in enumerate(halos):
        assert lo.shape == hi.shape == (2, 5, 1)
        want_lo = padded[(j - 1) % 3][:, :, -1:]
        want_hi = padded[(j + 1) % 3][:, :, :1]
        if j == 0 and boundary != ct.BoundaryMode.WRAP:
            want_lo = torch.zeros_like(want_lo)
        if j == 2 and boundary == ct.BoundaryMode.CLAMP:
            want_hi = torch.zeros_like(want_hi)
        assert torch.equal(lo, want_lo) and torch.equal(hi, want_hi)
    # The corner words are the neighbours' z halos.
    lo, _ = halos[1]
    assert int(lo[0, 0, 0]) == -1 and int(lo[0, -1, 0]) == -11


def test_slab_twin_is_the_padded_step():
    """fires_slab is fires_plane on the padded slab and its interior, the
    JAX package's _local_step_binary on the same halos."""
    jspec, tspec = specs(**RULE)
    g = torch.Generator().manual_seed(5)
    local = torch.randint(-2**31, 2**31 - 1, (1, 4, 8), dtype=torch.int32, generator=g)
    zh = tuple(torch.randint(-2**31, 2**31 - 1, (1, 1, 8), dtype=torch.int32, generator=g)
               for _ in range(2))
    yh = tuple(torch.randint(-2**31, 2**31 - 1, (1, 6, 1), dtype=torch.int32, generator=g)
               for _ in range(2))
    from cellularautomatons3d_tpu.ops.ca_step import fires_plane as jfires

    padded = ca_step.pad_slab(local, zh, yh)
    want = np.asarray(jfires(jnp.asarray(padded.numpy().view(np.uint32)), jspec))[:, 1:-1, 1:-1]
    got = ca_step.fires_slab(local, zh, yh, tspec)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    assert got.is_contiguous()
