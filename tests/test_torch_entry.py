"""The flagship forward step (``cellularautomatons3d_tpu_torch.entry``)
against the JAX package's ``__graft_entry__.entry``.

At 32³ / 128×64 (``_example(32, 128, 64)`` in both packages) the port's
``fn`` is fed JAX's own example arguments through ``interop.from_reference``
and chained over two calls beside JAX's ``fn`` run eagerly
(``jax.disable_jit()``: jitted, XLA:CPU contracts the march's products into
FMAs and rounds its float32 ``sin`` otherwise, tests/_torch_reference_scene.py).
The states must agree bit for bit and the frames with no pixel outside
``_torch_reference_scene.compare``: the hit mask equal, the f16 history depth
within 1 f16 ulp, the presentation rgb within rtol 3e-3 / atol 3e-4.
"""

import dataclasses
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_multistate_scene import one_torch_thread  # noqa: F401  (autouse)
from _torch_reference_scene import compare
import cellularautomatons3d_tpu_torch as ct
from cellularautomatons3d_tpu_torch import entry as entry_mod
from cellularautomatons3d_tpu_torch.entry import entry
from cellularautomatons3d_tpu_torch.render import renderer as tr

ROOT = Path(__file__).resolve().parents[1]
SMALL = (32, 128, 64)   # grid, width, height


def graft():
    """The JAX package's ``__graft_entry__`` module, loaded from the repo root."""
    spec = importlib.util.spec_from_file_location("__graft_entry__", ROOT / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def small_fns():
    """(JAX's fn with its example arguments, the port's fn), each built by
    its package's ``entry()`` on ``_example(32, 128, 64)``."""
    g = graft()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(g, "_example", lambda _ex=g._example: _ex(*SMALL))
        jfn, jargs = g.entry()
        mp.setattr(entry_mod, "_example",
                   lambda device, _ex=entry_mod._example: _ex(*SMALL, device=device))
        fn, _ = entry(device="cpu")
    return jfn, jargs, fn


def as_numpy_frame(frame, history):
    """(presentation, history colour, history depth) as numpy."""
    return tuple(np.asarray(x) for x in (frame, history.color, history.depth))


@pytest.fixture(scope="module")
def chained():
    """Two chained calls of each fn from JAX's example arguments: a list of
    (port frame, JAX frame, port state, JAX state) per call."""
    import jax

    jfn, (jpacked, jparams, jhist), fn = small_fns()
    packed = ct.from_reference(jpacked, device="cpu")
    params = ct.from_reference(jparams, device="cpu")
    hist = ct.from_reference(jhist, device="cpu")
    out = []
    for _ in range(2):
        with jax.disable_jit():
            jframe, jpacked, jhist = jfn(jpacked, jparams, jhist)
        frame, packed, hist = fn(packed, params, hist)
        out.append((as_numpy_frame(frame, hist), as_numpy_frame(jframe, jhist),
                    ct.to_reference(packed), np.asarray(jpacked)))
    return out


def test_example_matches_jax():
    g = graft()
    jspec, js, jpacked, jparams, jhist = g._example(*SMALL)
    spec, s, packed, params, hist = entry_mod._example(*SMALL, device="cpu")
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    for f in dataclasses.fields(s):
        assert getattr(s, f.name) == getattr(js, f.name), f.name
    assert (s.depth_samples, s.shadow_samples) == (16, 8)
    assert packed.dtype == torch.int32 and packed.device.type == "cpu"
    assert torch.equal(packed, ct.from_reference(jpacked, device="cpu"))
    np.testing.assert_array_equal(ct.to_reference(packed), np.asarray(jpacked))
    for name, a, b in zip(tr.RenderParams._fields, params, ct.from_reference(jparams)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name
    for a, b in zip(hist, ct.from_reference(jhist, device="cpu")):
        assert a.dtype == b.dtype == torch.float16 and torch.equal(a, b)


@pytest.mark.parametrize("call", [0, 1])
def test_fn_state_matches_eager_jax_bit_for_bit(chained, call):
    _, _, state, jstate = chained[call]
    assert state.dtype == jstate.dtype == np.uint32
    np.testing.assert_array_equal(state, jstate)


@pytest.mark.parametrize("call", [0, 1])
def test_fn_frame_matches_eager_jax(chained, call):
    got, want, _, _ = chained[call]
    # The stated tolerance: no pixel outside the comparison.
    assert compare(got, want) == dict(hit=0.0, depth=0.0, rgb=0.0)
    assert int((want[0].sum(-1) > 0).sum()) > 0
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == b.dtype == np.float16 and a.shape == b.shape


def test_entry_at_its_own_size_on_the_cpu():
    fn, (packed, params, hist) = entry(device="cpu")
    assert packed.dtype == torch.int32 and tuple(packed.shape) == (2, 64, 64)
    frame, new_packed, new_hist = fn(packed, params, hist)
    assert tuple(frame.shape) == (240, 320, 3) and frame.dtype == torch.float32
    assert bool(torch.isfinite(frame).all())
    # The 7 cells after one step light 16 of the 76,800 pixels.
    assert int((frame.sum(-1) > 0).sum()) > 10
    assert new_packed.dtype == torch.int32 and tuple(new_packed.shape) == (2, 64, 64)
    assert int(ct.unpack_grid(ct.to_reference(new_packed)).sum()) == 7
    assert isinstance(new_hist, tr.RenderHistory)
    assert new_hist.color.dtype == new_hist.depth.dtype == torch.float16
    assert tuple(new_hist.color.shape) == (240, 320, 4)
    assert tuple(new_hist.depth.shape) == (240, 320, 2)
    # fn leaves its inputs as they were.
    assert int(ct.unpack_grid(ct.to_reference(packed)).sum()) == 1
    assert not bool(hist.color.any()) and not bool(hist.depth.any())


def test_entry_does_not_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        entry(device="cuda")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        entry_mod.main([])
    with pytest.raises(ValueError, match="unsupported device"):
        entry(device="meta")


@pytest.mark.parametrize("argv, expect", [
    ([], "entry OK: ((240, 320, 3), (2, 64, 64), RenderHistory(color=(240, 320, 4), "
         "depth=(240, 320, 2)))"),
    (["dryrun", "2"], "dryrun_multichip OK: 2-shard mesh on ['cpu'], grid 64^3"),
], ids=["step", "dryrun"])
def test_command_line_imports_no_jax(argv, expect):
    code = (
        "import runpy, sys; sys.modules['jax'] = None; "
        f"sys.argv = ['entry', *{[*argv, '--device', 'cpu']!r}]; "
        "runpy.run_module('cellularautomatons3d_tpu_torch.entry', run_name='__main__', "
        "alter_sys=True); "
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules "
        "if sys.modules[m] is not None); "
        "assert not any(m.split('.')[0] == 'cellularautomatons3d_tpu' for m in sys.modules)"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1].startswith(expect), out.stdout


def test_render_params_round_trip():
    import jax.numpy as jnp
    from cellularautomatons3d_tpu.render import renderer as jr

    jparams = graft()._example(*SMALL)[3]._replace(
        light_radius=jnp.float32(0.08), emissive_color=jnp.asarray([0.5, 0.25, 1.0], jnp.float32))
    params = ct.from_reference(jparams)
    assert isinstance(params, tr.RenderParams)
    back = jr.RenderParams(*ct.to_reference(params))
    for name, a, b in zip(jr.RenderParams._fields, jparams, back):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name


def test_render_params_reject_other_types():
    jparams = graft()._example(*SMALL)[3]
    with pytest.raises(TypeError, match="RenderParams.gamma"):
        ct.from_reference(jparams._replace(gamma=np.float64(2.0)))
    params = entry_mod._example(*SMALL, device="cpu")[3]
    with pytest.raises(TypeError, match="RenderParams.light_pos"):
        ct.to_reference(params._replace(light_pos=np.zeros(3)))
