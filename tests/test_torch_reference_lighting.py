"""The reference pipeline's extended lighting: soft shadows over a jittered
area light, one-bounce GI and two-bounce GI.  The port's ``render_frame`` on
the CPU against the JAX package's, jitted and eager, at 32³ / 64×48 on a
numpy-seeded random volume (tests/_torch_reference_scene.py states the
comparison)."""

import numpy as np
import pytest

from _torch_multistate_scene import one_torch_thread  # noqa: F401  (autouse)
from _torch_reference_scene import compare, jax_frame, params, random_words, torch_frame

# (RenderStatic keywords, the depth and rgb mismatch fractions allowed
# against the jitted frame).  Measured: 2.15 % in depth on each (the march's
# hash), and in rgb 10.48 % with soft shadows (the jitter hash: XLA's fused
# dot product moves its argument by an ulp, which moves sin(·) · 43758.5453
# by up to ~0.3, on ~10 % of the values), 1.33 % with one bounce and 1.46 %
# with two.  Against eager JAX every fraction is 0.
CASES = {
    "soft_shadows_4": (dict(soft_shadow_samples=4), 3e-2, 1.2e-1),
    "gi_one_bounce": (dict(indirect_lighting=True), 3e-2, 2e-2),
    "gi_two_bounces": (dict(indirect_lighting=True, indirect_bounces=2), 3e-2, 2e-2),
}


@pytest.fixture(scope="module")
def scene():
    return random_words(0), params(light_radius=0.08)


@pytest.mark.parametrize("case", list(CASES))
def test_lighting_matches_jax(case, scene):
    static, depth, rgb = CASES[case]
    words, p = scene
    got = torch_frame(static, words, p)[0]
    compare(got, jax_frame(static, words, p)[0], depth=depth, rgb=rgb)
    assert compare(got, jax_frame(static, words, p, eager=True)[0]) == dict(
        hit=0.0, depth=0.0, rgb=0.0)
    hard = torch_frame({}, words, p)[0]
    np.testing.assert_array_equal(hard[2], got[2])  # the same march
    assert not np.allclose(hard[0], got[0])
