"""``bench_torch.py`` (the port's counterpart of ``bench.py``) and the fused
loop's runtime reset period it relies on.

* The compose loop (K1 in compose mode, hard shadows), built with
  ``reset_every=2`` and run with ``reset_period`` None / 2 / 0, against the JAX
  package's ``make_fused_loop`` at 32³ / 128×64 from the centre seed after 8
  generations, over 4 frames: one jitted JAX program with the Pallas kernel in
  interpret mode serves the three cases (the reset period is its operand).
  Contract: final state bit for bit, history ids equal, frame and history
  colour within rtol 3e-3 / atol 3e-4 (tests/test_tpu_kernel.py:52-56).
* The other two branches (the extended frame, ``render_frame_fast`` per
  iteration), port against port: ``reset_period=k`` equals a loop built with
  ``reset_every=k``.
* The entry point at a test size on the CPU: one JSON line with every key of
  ``bench.py``'s line (read from its source with ``ast``: it imports JAX) and
  the spread, finite and positive; no JAX import; no line and a non-zero exit
  without CUDA; ``measure`` returns the pinned scene.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cellularautomatons3d_tpu as jca
from cellularautomatons3d_tpu.ops.loop import make_multi_step as jax_multi_step
from cellularautomatons3d_tpu.render import renderer as jren
from cellularautomatons3d_tpu.render import renderer_fast as jrf

import cellularautomatons3d_tpu_torch as ct
from cellularautomatons3d_tpu_torch.ops.loop import make_multi_step
from cellularautomatons3d_tpu_torch.render import renderer, renderer_fast
from cellularautomatons3d_tpu_torch.tools import common

import bench_torch
from bench_torch import bench_py_keys

ROOT = Path(__file__).resolve().parent.parent
N, W, H = 32, 128, 64
GENS, FRAMES, RESET = 8, 4, 2
SMALL = ["--device", "cpu", "--grid", "32", "--width", "64", "--height", "32", "--frames", "4",
         "--steps", "10", "--warmup-gens", "8", "--repeats", "2"]


@pytest.fixture(scope="module")
def jax_compose_loop():
    """(the gen-8 scene as uint32 words, ``call(reset_period)`` -> JAX's
    numpy (state, history colour, history ids, last frame))."""
    spec = jca.AutomatonSpec.from_config(jca.EngineConfig(grid_size=N))
    scene = np.asarray(jax_multi_step(spec, GENS)(jnp.asarray(jca.pack_grid(jca.seed_center(N)))))
    s = jren.RenderStatic(width=W, height=H, grid_size=N, depth_samples=35, shadow_samples=30)
    params = jren.RenderParams(**{k: jnp.asarray(v) for k, v in
                                  common.render_params(W, H)._asdict().items()})
    run = jrf.make_fused_loop(s, spec, FRAMES, reset_every=RESET)

    def call(reset_period):
        args = (jnp.asarray(scene), params, jrf.init_fast_history(W, H))
        st, hist, frame = run(*args) if reset_period is None else run(*args, reset_period)
        return tuple(np.asarray(a) for a in (st, hist.color, hist.hit_idx, frame))

    return scene, call


@pytest.mark.parametrize("reset_period", [None, 2, 0])
def test_compose_loop_reset_period_matches_jax(jax_compose_loop, reset_period):
    scene, call = jax_compose_loop
    want = call(reset_period)
    spec = common.spec_of(N)
    start = common.scene(N, GENS, "cpu")
    np.testing.assert_array_equal(ct.to_reference(start), scene)
    s = renderer.RenderStatic(width=W, height=H, grid_size=N)
    run = renderer_fast.make_fused_loop(s, spec, FRAMES, reset_every=RESET)
    args = (start, common.render_params(W, H), renderer_fast.init_fast_history(W, H, "cpu"))
    st, hist, frame = run(*args) if reset_period is None else run(*args, reset_period)
    np.testing.assert_array_equal(ct.to_reference(st), want[0])
    # Period 2 over 4 frames ends on the scene; period 0 steps 4 times.
    assert torch.equal(st, start if reset_period != 0 else make_multi_step(spec, FRAMES)(start))
    np.testing.assert_array_equal(hist.hit_idx.numpy(), want[2])
    assert (want[2] >= 0).sum() > 100
    np.testing.assert_allclose(frame.numpy(), want[3], rtol=3e-3, atol=3e-4)
    np.testing.assert_allclose(hist.color.float().numpy(), want[1].astype(np.float32),
                               rtol=3e-3, atol=3e-4)


@pytest.mark.parametrize("branch", [dict(soft_shadow_samples=4, light_radius=0.08),
                                    dict(force_sliced=True)], ids=["extended", "per_frame"])
def test_reset_period_equals_a_loop_built_with_reset_every(branch):
    """The extended frame and ``render_frame_fast`` per iteration: the
    runtime period gives the loop that ``reset_every`` builds, and differs
    from no reset."""
    kw = {k: v for k, v in branch.items() if k != "light_radius"}
    s = renderer.RenderStatic(width=64, height=32, grid_size=N, **kw)
    spec = common.spec_of(N)
    start = common.scene(N, GENS, "cpu")
    params = common.render_params(64, 32)._replace(
        light_radius=np.float32(branch.get("light_radius", 0.0)))

    def go(run, *rp):
        return run(start, params, renderer_fast.init_fast_history(64, 32, "cpu"), *rp)

    runtime = go(renderer_fast.make_fused_loop(s, spec, 3), 2)
    built = go(renderer_fast.make_fused_loop(s, spec, 3, reset_every=2))
    none = go(renderer_fast.make_fused_loop(s, spec, 3, reset_every=2), 0)
    assert torch.equal(runtime[0], built[0]) and torch.equal(runtime[2], built[2])
    assert all(torch.equal(a, b) for a, b in zip(runtime[1], built[1]))
    assert torch.equal(runtime[0], make_multi_step(spec, 1)(start))
    assert torch.equal(none[0], make_multi_step(spec, 3)(start))
    assert (runtime[1].hit_idx >= 0).sum() > 20


def run_bench(code_or_args, env=None):
    cmd = ([sys.executable, "-c", code_or_args] if isinstance(code_or_args, str)
           else [sys.executable, "bench_torch.py", *code_or_args])
    return subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300,
                          env={**os.environ, **(env or {})})


def check_line(stdout: str) -> dict:
    lines = stdout.splitlines()
    assert len(lines) == 1, stdout
    rec = json.loads(lines[0])
    assert bench_py_keys() | {"repeats", "spread"} <= set(rec)
    assert rec["device"] == "cpu" and rec["unit"] == "ms" and rec["repeats"] == 2
    assert rec["metric"] == "32^3 CA step + composed 32p path-traced frame"
    numbers = [rec[k] for k in bench_py_keys() - {"metric", "unit", "device"}]
    numbers += [v for k in ("value", "dense_scene_ms", "step_ms")
                for v in (rec["spread"][k]["min"], rec["spread"][k]["max"])]
    assert len(numbers) == 13 and all(math.isfinite(x) and x > 0 for x in numbers)
    for k in ("value", "dense_scene_ms", "step_ms"):
        assert rec["spread"][k]["min"] <= rec[k] <= rec["spread"][k]["max"]
    assert rec["frame_ms"] == pytest.approx(rec["value"] - rec["step_ms"])
    assert rec["vs_baseline"] == pytest.approx(16.0 / rec["value"])
    return rec


def test_bench_py_keys_are_the_reference_line():
    assert bench_py_keys() == {"metric", "value", "unit", "vs_baseline", "dense_scene_ms",
                               "step_ms", "frame_ms", "ca_steps_per_sec", "fps", "device"}


def test_bench_torch_prints_one_line_with_every_key_on_the_cpu():
    out = run_bench(SMALL)
    assert out.returncode == 0, out.stderr
    check_line(out.stdout)
    assert "pinned =" in out.stderr and "dense =" in out.stderr


def test_bench_torch_imports_no_jax():
    code = (
        "import runpy, sys; sys.modules['jax'] = None; "
        f"sys.argv = ['bench_torch.py', *{SMALL!r}]; "
        "runpy.run_path('bench_torch.py', run_name='__main__'); "
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules "
        "if sys.modules[m] is not None); "
        "assert not any(m.split('.')[0] == 'cellularautomatons3d_tpu' for m in sys.modules)"
    )
    out = run_bench(code)
    assert out.returncode == 0, out.stderr
    check_line(out.stdout)


def test_bench_torch_without_cuda_prints_nothing_and_fails():
    out = run_bench([], env={"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout == ""
    assert "cuda" in out.stderr.lower()


def test_measure_returns_the_pinned_scene(monkeypatch):
    rec, state, frame = bench_torch.measure(grid=N, width=64, height=32, frames=10, steps=2,
                                            warmup_gens=GENS, repeats=1, device="cpu")
    assert torch.equal(state, common.scene(N, GENS, "cpu"))
    assert tuple(frame.shape) == (32, 64, 3) and bool(torch.isfinite(frame).all())
    assert float(frame.max()) > 0.0
    assert rec["device"] == "cpu" and rec["repeats"] == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        bench_torch.measure(grid=N, device="cuda")
