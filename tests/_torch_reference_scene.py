"""Shared scenes and checks of the reference-pipeline tests
(tests/test_torch_reference_*.py): the port's ``render.renderer.render_frame``
against the JAX package's, at the size of tests/test_render.py (32³ /
64×48), with numpy-seeded volumes and the parameters of its
``make_params``.

The JAX side is ``render_frame`` jitted, as tests/test_render.py runs it,
and for some cases also eager (``jax.disable_jit()``).  Jitted, XLA:CPU
fuses the march and contracts its products and sums into FMAs (the hash's
dot product included), so a sample can land across a cell's edge and a
march or shadow latch another cell: such pixels are counted, and each test
states the fraction it allows.  Eager JAX rounds op by op as the port does:
there the port's frames agree on every pixel.

The comparison (:func:`compare`, also used by tests/test_torch_cuda.py and
chip_smoke.py to hold the card's frames to the CPU's):

* ``hit``: pixels whose hit mask (history depth > 0, the volume's slab
  test) differs;
* ``depth``: pixels whose f16 history depth differs by more than 1 f16 ulp
  (the march latched another cell);
* ``rgb``: of the pixels whose depth agrees, those whose presentation rgb
  is outside rtol 3e-3 / atol 3e-4 (the contract of
  tests/test_tpu_kernel.py:52-56; a shadow ray latched another cell).
"""

import numpy as np

N, W, H = 32, 64, 48
RGB_RTOL, RGB_ATOL = 3e-3, 3e-4


def params(view=None, prev=None, t=0.1, **kw):
    """RenderParams fields as numpy float32 values: tests/test_render.py's
    ``make_params``, with the previous camera ``prev`` (default: ``view``)."""
    from cellularautomatons3d_tpu_torch.utils import mat4

    view = mat4.initial_view_matrix() if view is None else view
    prev = view if prev is None else prev
    proj = mat4.initial_projection_matrix(W, H)
    f32 = np.float32
    out = dict(
        view_mat=np.asarray(view, f32),
        prev_view_mat=np.asarray(prev, f32),
        prev_proj_view=np.asarray(mat4.multiply(proj, mat4.inverse(prev)), f32),
        elapsed_time=f32(t),
        cell_size=f32(0.85),
        temporal_alpha=f32(0.1),
        gamma=f32(2.0),
        roughness=f32(0.29),
        base_reflectivity=np.full(3, 0.17, f32),
        material_color=np.zeros(3, f32),
        light_pos=np.asarray([0.721, 1.0, 1.0], f32),
        light_magnitude=f32(5.0),
        show_depth_overlay=f32(0.0),
    )
    out.update({k: np.asarray(v, f32) for k, v in kw.items()})
    return out


def block_words(lo=12, hi=20):
    """uint32 [1, N, N] packed words of a solid block of cells [lo, hi)³."""
    from cellularautomatons3d_tpu_torch import pack_grid

    dense = np.zeros((N, N, N), np.uint8)
    dense[lo:hi, lo:hi, lo:hi] = 1
    return pack_grid(dense)


def random_words(seed=0, p=0.08):
    """Packed words of a random volume with ``p`` of its cells live."""
    from cellularautomatons3d_tpu_torch import pack_grid

    rng = np.random.default_rng(seed)
    return pack_grid((rng.random((N, N, N)) < p).astype(np.uint8))


def jax_frame(static, words, p, history=None, ages=None, total_states=2,
              variant="clustered", eager=False):
    """JAX's ``render_frame``: (presentation, history colour, history depth)
    as numpy, and the JAX history.  ``static``: RenderStatic keywords."""
    import jax
    import jax.numpy as jnp
    from cellularautomatons3d_tpu.render import renderer as jr

    s = jr.RenderStatic(width=W, height=H, grid_size=N, **static)
    if history is None:
        history = jr.init_history(W, H)
    run = lambda: jr.render_frame(  # noqa: E731
        s, jnp.asarray(words), jr.RenderParams(**{k: jnp.asarray(v) for k, v in p.items()}),
        history, None if ages is None else jnp.asarray(ages), total_states, variant)
    if eager:
        with jax.disable_jit():
            frame, hist = run()
    else:
        frame, hist = run()
    return (np.asarray(frame), np.asarray(hist.color), np.asarray(hist.depth)), hist


def torch_frame(static, words, p, history=None, ages=None, total_states=2,
                variant="clustered"):
    """The port's ``render_frame`` on the CPU, as :func:`jax_frame`."""
    import cellularautomatons3d_tpu_torch as ct
    from cellularautomatons3d_tpu_torch.render import renderer as tr

    s = tr.RenderStatic(width=W, height=H, grid_size=N, **static)
    if history is None:
        history = tr.init_history(W, H, "cpu")
    frame, hist = tr.render_frame(
        s, ct.from_reference(words, device="cpu"), tr.RenderParams(**p), history,
        None if ages is None else ct.from_reference(ages, device="cpu"), total_states,
        variant)
    return (frame.numpy(), hist.color.numpy(), hist.depth.numpy()), hist


def f16_ulp(a, b):
    """One f16 ulp of the larger magnitude of ``a`` and ``b``."""
    m = np.maximum(np.abs(a.astype(np.float32)), np.abs(b.astype(np.float32)))
    return np.spacing(m.astype(np.float16)).astype(np.float32)


def compare(got, want, hit=0.0, depth=0.0, rgb=0.0):
    """Hold the port's frame ``got`` to ``want`` (each (presentation, colour,
    depth) numpy): the hit, depth and rgb mismatch fractions (module
    docstring) at most ``hit``, ``depth`` and ``rgb``.  Returns the
    fractions."""
    frame_g, _, depth_g = got
    frame_w, _, depth_w = want
    assert frame_g.shape == frame_w.shape and frame_g.shape[-1] == 3
    dg, dw = depth_g[..., 0], depth_w[..., 0]
    hit_bad = (dg > 0) != (dw > 0)
    depth_bad = np.abs(dg.astype(np.float32) - dw.astype(np.float32)) > f16_ulp(dg, dw)
    close = np.isclose(frame_g, frame_w, rtol=RGB_RTOL, atol=RGB_ATOL, equal_nan=True)
    rgb_bad = ~close.all(-1) & ~depth_bad
    fr = dict(hit=float(hit_bad.mean()), depth=float(depth_bad.mean()),
              rgb=float(rgb_bad.mean()))
    assert fr["hit"] <= hit and fr["depth"] <= depth and fr["rgb"] <= rgb, (
        f"mismatch fractions {fr} above the stated hit {hit}, depth {depth}, rgb {rgb}")
    # The second channel of the depth target is 1 on every pixel.
    assert (depth_g[..., 1] == 1).all() and (depth_w[..., 1] == 1).all()
    return fr
