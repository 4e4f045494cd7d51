"""The reference pipeline's variants: the simple (non-clustered) shader and
the multi-state age fade.  The port's ``render_frame`` on the CPU against
the JAX package's, jitted and eager, at 32³ / 64×48 on numpy-seeded scenes
(tests/_torch_reference_scene.py states the comparison)."""

import numpy as np
import pytest

from _torch_multistate_scene import pack_ages, random_ages, visibility
from _torch_multistate_scene import one_torch_thread  # noqa: F401  (autouse)
from _torch_reference_scene import (
    N, block_words, compare, jax_frame, params, random_words, torch_frame,
)

STATIC = dict(depth_samples=35, shadow_samples=30)
S_PYRO = 10  # the pyroclastic preset's states: 4 age planes


@pytest.fixture(scope="module", params=["block", "random"])
def simple_frames(request):
    words = block_words() if request.param == "block" else random_words(3)
    p = params()
    return request.param, [f(STATIC, words, p, variant="simple", **kw)[0] for f, kw in (
        (torch_frame, {}), (jax_frame, {}), (jax_frame, dict(eager=True)))]


def test_simple_variant_matches_jax(simple_frames):
    """The simple shader (reflect + diffuse, no cell-size floor on the
    shadow step, alpha 0.1 and gamma 2.2).  Jitted: 2.41 % of the pixels
    in depth and 0.42 % in rgb measured on the random scene, 0.10 % and 0
    on the block; eager: none."""
    scene, (got, want, eager) = simple_frames
    limit = 3e-3 if scene == "block" else 3e-2
    compare(got, want, depth=limit, rgb=limit)
    assert compare(got, eager) == dict(hit=0.0, depth=0.0, rgb=0.0)
    lit = got[0].sum(-1) > 0
    assert lit.sum() > 100


def test_simple_variant_differs_from_clustered():
    """Same scene, other shader: the lighting and the gamma change, the
    march does not."""
    words, p = block_words(), params()
    simple = torch_frame(STATIC, words, p, variant="simple")[0]
    clustered = torch_frame(STATIC, words, p)[0]
    np.testing.assert_array_equal(simple[2], clustered[2])
    assert not np.allclose(simple[0], clustered[0])


@pytest.fixture(scope="module")
def pyroclastic_scene():
    ages = random_ages(N, S_PYRO, 31, p_dead=0.9)
    planes = pack_ages(ages, 4)
    return ages, planes, visibility(planes)


def test_pyroclastic_ages_fade_and_match_jax(pyroclastic_scene):
    """A 10-state scene: hit cells fade by (S - age) / (S - 1).  Jitted:
    2.47 % of the pixels in depth and 0.88 % in rgb measured; eager: none."""
    ages, planes, vis = pyroclastic_scene
    p = params()
    kw = dict(ages=planes, total_states=S_PYRO)
    got = torch_frame(STATIC, vis, p, **kw)[0]
    compare(got, jax_frame(STATIC, vis, p, **kw)[0], depth=3e-2, rgb=1.5e-2)
    assert compare(got, jax_frame(STATIC, vis, p, eager=True, **kw)[0]) == dict(
        hit=0.0, depth=0.0, rgb=0.0)
    binary = torch_frame(STATIC, vis, p)[0]
    np.testing.assert_array_equal(binary[2], got[2])  # the same march
    assert (got[1][..., :3] <= binary[1][..., :3]).all()
    assert (got[1][..., :3] < binary[1][..., :3]).any()
