"""Checkpoints: the port's ``Engine.save`` / ``Engine.load`` write and read
the JAX package's npz format (engine.py:457-489 and 573-608 there).

A file from either package loads in the other: the state bit-exact (packed
``uint32`` words, or age planes for a multi-state rule), the history, the
camera with its previous matrices and the counters equal.  The JAX engines
here render nothing: they step, and their history is set from the port's
frame.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cellularautomatons3d_tpu as jca
from cellularautomatons3d_tpu.render.renderer_fast import FastHistory as JaxHistory

import cellularautomatons3d_tpu_torch as ct

CFG = dict(grid_size=32, width=64, height=32)
RULES = {
    "binary": {},
    "pyroclastic": dict(ct.PRESETS["pyroclastic"], random_initial_state=True),
}


def port_engine(rule):
    """A port Engine after a few moved ticks: live history, previous
    matrices and a part-accumulated frame timer."""
    eng = ct.Engine(ct.EngineConfig(**CFG, **RULES[rule]), device="cpu")
    eng.step(6)
    for i in range(3):
        eng.camera.translate((1, 0, -1), 0.03)
        eng.camera.mouse_look(4.0 + i, -2.0)
        eng.tick(dt_ms=15.0)
    assert (eng.history.hit_idx >= 0).any() and 0 < eng._frame_duration
    return eng


def assert_same_checkpoint(a, b):
    """Two engines (either package) hold the same checkpointed state."""
    np.testing.assert_array_equal(ct.to_reference(a.state) if torch.is_tensor(a.state)
                                  else np.asarray(a.state),
                                  ct.to_reference(b.state) if torch.is_tensor(b.state)
                                  else np.asarray(b.state))
    for x, y in ((a.history.color, b.history.color), (a.history.hit_idx, b.history.hit_idx)):
        x = x.numpy() if torch.is_tensor(x) else np.asarray(x)
        y = y.numpy() if torch.is_tensor(y) else np.asarray(y)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    for name in ("view_mat", "prev_view_mat", "prev_proj_view"):
        np.testing.assert_array_equal(getattr(a.camera, name), getattr(b.camera, name))
    assert a.simulation_step == b.simulation_step
    assert a._time_ms == b._time_ms and a._frame_duration == b._frame_duration
    # The config travels as the JSON of dataclasses.asdict (tuples as lists).
    assert json.dumps(dataclasses.asdict(a.config)) == json.dumps(dataclasses.asdict(b.config))


@pytest.mark.parametrize("rule", sorted(RULES))
def test_port_round_trip_then_same_frames(rule, tmp_path):
    eng = port_engine(rule)
    path = str(tmp_path / "ckpt.npz")
    eng.save(path)
    with np.load(path) as data:
        assert data["state"].dtype == np.uint32
        assert data["history_color"].dtype == np.float16
        assert data["history_idx"].dtype == np.int32
    back = ct.Engine.load(path, device="cpu")
    assert back.device == torch.device("cpu")
    assert torch.equal(back.state, eng.state)
    assert_same_checkpoint(back, eng)
    # The resumed engine continues bit for bit: a moved frame (the
    # reprojection reads the restored history and matrices), then ticks.
    for e in (eng, back):
        e.camera.rotate((0, 1, 0), 0.02)
    assert torch.equal(back.render(), eng.render())
    for _ in range(3):
        assert torch.equal(back.tick(), eng.tick())
    assert torch.equal(back.state, eng.state)


@pytest.mark.parametrize("rule", sorted(RULES))
def test_jax_checkpoint_loads_in_the_port(rule, tmp_path):
    port = port_engine(rule)
    jeng = jca.Engine(jca.EngineConfig(**CFG, **RULES[rule]))
    jeng.step(port.simulation_step)
    jeng.history = JaxHistory(*map(jnp.asarray, ct.to_reference(port.history)))
    for name in ("view_mat", "prev_view_mat", "prev_proj_view"):
        setattr(jeng.camera, name, getattr(port.camera, name).copy())
    jeng._time_ms, jeng._frame_duration = port._time_ms, port._frame_duration
    path = str(tmp_path / "jax.npz")
    jeng.save(path)
    eng = ct.Engine.load(path, device="cpu")
    assert_same_checkpoint(eng, jeng)
    # The JAX engine stepped the same rule from the same seed.
    assert torch.equal(eng.state, port.state)


@pytest.mark.parametrize("rule", sorted(RULES))
def test_port_checkpoint_loads_in_jax(rule, tmp_path):
    eng = port_engine(rule)
    path = str(tmp_path / "port.npz")
    eng.save(path)
    jeng = jca.Engine.load(path)
    assert_same_checkpoint(eng, jeng)
    # Both continue the automaton alike.
    jeng.step(3)
    eng.step(3)
    np.testing.assert_array_equal(ct.to_reference(eng.state), np.asarray(jeng.state))


def test_older_checkpoint_keeps_defaults(tmp_path):
    """Files from before ``prev_proj_view`` and ``frame_duration`` load with
    the defaults, as the reference's loader keeps them."""
    eng = port_engine("binary")
    path = str(tmp_path / "new.npz")
    eng.save(path)
    with np.load(path) as data:
        old = {k: data[k] for k in data.files if k not in ("prev_proj_view", "frame_duration")}
    old_path = str(tmp_path / "old.npz")
    np.savez_compressed(old_path, **old)
    back = ct.Engine.load(old_path, device="cpu")
    np.testing.assert_array_equal(back.camera.prev_proj_view, np.eye(4, dtype=np.float32))
    assert back._frame_duration == 0.0
    np.testing.assert_array_equal(back.camera.prev_view_mat, eng.camera.prev_view_mat)
    assert torch.equal(back.state, eng.state) and back.simulation_step == eng.simulation_step
    assert bool(torch.isfinite(back.render()).all())


def test_orbax_and_foreign_checkpoints_raise(tmp_path):
    eng = ct.Engine(ct.EngineConfig(**CFG), device="cpu")
    with pytest.raises(NotImplementedError, match="cellularautomatons3d_tpu"):
        eng.save(str(tmp_path / "ckpt"), backend="orbax")
    with pytest.raises(ValueError, match="backend"):
        eng.save(str(tmp_path / "ckpt"), backend="pickle")
    (tmp_path / "orbax_dir").mkdir()
    with pytest.raises(NotImplementedError, match="cellularautomatons3d_tpu"):
        ct.Engine.load(str(tmp_path / "orbax_dir"), device="cpu")
    # A state that does not fit the file's config is refused.
    path = str(tmp_path / "bad.npz")
    eng.save(path)
    with np.load(path) as data:
        files = {k: data[k] for k in data.files}
    files["state"] = files["state"].astype(np.int32)
    np.savez_compressed(path, **files)
    with pytest.raises(ValueError, match="uint32"):
        ct.Engine.load(path, device="cpu")


def test_load_on_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    eng = ct.Engine(ct.EngineConfig(**CFG), device="cpu")
    path = str(tmp_path / "ckpt.npz")
    eng.save(path)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        ct.Engine.load(path)
