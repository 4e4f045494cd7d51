"""The reference's Generations rule, its age-faded and sliced frames and its
replay of ``render_frame_fast`` against the port's plain twins at 32³ /
64×32; whole small runs of candidate configurations that no cell runs yet
(a temporary ``BENCHMARK.json``): a sound run is correct, the control and
planted faults are not; and the configurations the check refuses before a
run's window."""

import json

import numpy as np
import pytest
import torch

import harness
from _small import SEED, SMALL, run
from reference import ca, frozen

RULES = {   # the port's presets (models/presets.py)
    "pyroclastic": dict(neighbourhood="moore", born="6-8", survive="4-7", total_states=10),
    "amoeba-445": dict(neighbourhood="moore", born="4", survive="4", total_states=5),
}
BOUNDARIES = ("clamp_ref", "wrap", "clamp")
N, W, H = SMALL["grid"], SMALL["width"], SMALL["height"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rule(preset, boundary="clamp_ref"):
    return ca.rule_of(dict(RULES[preset], boundary=boundary))


def _spec(preset, boundary="clamp_ref", n=N):
    from cellularautomatons3d_tpu_torch.models.automaton import AutomatonSpec
    r = RULES[preset]
    return AutomatonSpec.from_rule_strings(n, r["neighbourhood"], r["born"], r["survive"],
                                           r["total_states"], boundary)


def random_ages(n, states, seed, p_dead=0.6):
    """Dense ages [n, n, n] of every value 0 .. states − 1, edges included."""
    rng = np.random.default_rng(seed)
    ages = rng.integers(1, states, (n, n, n)).astype(np.uint8)
    ages[rng.random((n, n, n)) < p_dead] = 0
    return torch.from_numpy(ages)


def numpy_moore_count(alive: np.ndarray, boundary: str) -> np.ndarray:
    """The 26 neighbours' sum, one offset at a time: past the far edge the
    first row or plane (``clamp_ref``, ``wrap``), before the near edge dead
    (``clamp_ref``, ``clamp``) or the last one (``wrap``)."""
    n = alive.shape[0]
    count = np.zeros(alive.shape, np.int32)
    idx = np.arange(n)
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if (dx, dy, dz) == (0, 0, 0):
                    continue
                src = [idx + d for d in (dz, dy, dx)]
                ok = np.ones(alive.shape, bool)
                for axis, s in enumerate(src):
                    shape = [1, 1, 1]
                    shape[axis] = n
                    if boundary == "clamp":
                        ok &= ((s >= 0) & (s < n)).reshape(shape)
                    elif boundary == "clamp_ref":
                        ok &= (s >= 0).reshape(shape)
                    src[axis] = s % n
                count += np.where(ok, alive[np.ix_(*src)], 0)
    return count


@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_moore_count_matches_numpy(boundary):
    alive = (random_ages(N, 3, 5) == 1).numpy().astype(np.uint8)
    got = ca.moore_count(torch.from_numpy(alive), boundary)
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), numpy_moore_count(alive, boundary))


@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("preset", sorted(RULES))
def test_generations_step_equals_the_port(preset, boundary):
    """ca.step_ages packed into age planes against the port's plain
    step_packed_multistate, generation by generation, on random ages that
    reach every edge."""
    from cellularautomatons3d_tpu_torch.ops.ca_step import step_packed_multistate
    rule, spec = _rule(preset, boundary), _spec(preset, boundary)
    ages = random_ages(N, rule["states"], SEED)
    planes = ca.pack_ages(ages, spec.age_bits)
    seen = set()
    for _ in range(6):
        ages = ca.step_ages(ages, rule)
        planes = step_packed_multistate(planes, spec)
        assert torch.equal(ca.pack_ages(ages, spec.age_bits, block=8), planes)
        seen |= set(ages.unique().tolist())
    assert seen == set(range(rule["states"]))


@pytest.mark.parametrize("preset", sorted(RULES))
def test_scenes_equal_the_port_engine(preset):
    """The reference's scenes from the seed's random 5³ start against the
    port's Engine stepped as far, on the CPU."""
    from cellularautomatons3d_tpu_torch import Engine, EngineConfig
    eng = Engine(EngineConfig(grid_size=N, width=W, height=H, seed=SEED,
                              random_initial_state=True, **RULES[preset]), device="cpu")
    got = ca.scenes(ca.seed_block(N, SEED), _rule(preset), 4, 3, "cpu")
    for g in range(4):
        eng.step(4 if g == 0 else 1)
        assert torch.equal(got[g], eng.state)
        assert torch.equal(ca.visible(got[g]), eng._visibility_plane())


def test_binary_moore_scenes_step_by_the_box_count():
    rule = ca.rule_of(dict(neighbourhood="moore", born="4", survive="4", boundary="clamp_ref"))
    cells = (random_ages(N, 2, 9, p_dead=0.7) == 1).to(torch.uint8)
    got = ca.scenes(cells.numpy(), rule, 3, 1, "cpu")
    for _ in range(3):
        cells = ca.step(cells, rule)
    assert torch.equal(got[0], ca.pack(cells))
    assert torch.equal(got[1], ca.pack(ca.step(cells, rule)))


# ------------------------------------------------------------ frames ---


def _aged_scene(p_dead=0.75):
    """(ages, age planes, visibility plane) of a 10-state scene."""
    ages = random_ages(N, 10, 21, p_dead)
    planes = ca.pack_ages(ages, 4)
    return ages, planes, ca.visible(planes)


def _cam(config="clustered-256", degrees=37.0, t_ms=50.0):
    e = harness.engine_settings(harness.load_json(harness.HERE / "configs" / f"{config}.json"),
                                {"scene": "random"}, SEED, SMALL)
    view = harness.orbit_pose(degrees, 0.75, 0.2)
    p = harness.render_params(e, view, view, t_ms)
    return e, p, frozen.cam_vec(p, W, H)


@pytest.mark.parametrize("shadow", [True, False])
def test_aged_k1_trace_equals_the_port(shadow):
    from cellularautomatons3d_tpu_torch.render import render_fast
    _, planes, vol = _aged_scene()
    _, _, cam = _cam()
    tr = frozen.k1_trace(vol, cam, grid_size=N, width=W, height=H, shadow=shadow, ages=planes,
                         total_states=10)
    rgb, depth, idx = render_fast.raytrace(vol, None, cam, grid_size=N, width=W, height=H,
                                           shadow=shadow, ages=planes, total_states=10)
    assert torch.equal(idx, tr.idx) and torch.equal(depth, tr.depth)
    assert torch.equal(rgb, tr.rgb)
    plain = frozen.k1_trace(vol, cam, grid_size=N, width=W, height=H, shadow=shadow)
    assert not torch.equal(plain.rgb, tr.rgb), "the ages fade nothing in this scene"
    prev = (torch.rand(H, W, 3, generator=torch.Generator().manual_seed(2)),
            torch.where(torch.rand(H, W) < 0.5, tr.idx, -1).to(torch.int32))
    got = frozen.k1_compose(cam, tr, *prev)
    want = render_fast.raytrace(vol, None, cam, prev, grid_size=N, width=W, height=H,
                                shadow=shadow, ages=planes, total_states=10)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[3])


SLICED_LIGHT = {
    "hard": dict(soft_shadow_samples=1),
    "soft_gi2": dict(soft_shadow_samples=4, indirect=True, indirect_bounces=2),
}


@pytest.mark.parametrize("aged", [True, False], ids=["ages", "binary"])
@pytest.mark.parametrize("light", sorted(SLICED_LIGHT))
def test_sliced_trace_equals_the_port(light, aged):
    """frozen.sliced_trace against render_slab.raytrace_sliced (the frame
    trace_shaded takes under RenderStatic.force_sliced) bit for bit."""
    from cellularautomatons3d_tpu_torch.render import render_slab
    from cellularautomatons3d_tpu_torch.render.renderer import RenderStatic
    from cellularautomatons3d_tpu_torch.render.renderer_fast import trace_shaded
    _, planes, vol = _aged_scene()
    e, _, cam = _cam("pbr-256")
    kw = SLICED_LIGHT[light]
    ages = dict(ages=planes, total_states=10) if aged else {}
    want = render_slab.raytrace_sliced(vol, cam, grid_size=N, width=W, height=H,
                                       **ages, **kw)
    s = RenderStatic(width=W, height=H, grid_size=N, force_sliced=True,
                     soft_shadow_samples=kw["soft_shadow_samples"],
                     indirect_lighting=kw.get("indirect", False),
                     indirect_bounces=kw.get("indirect_bounces", 1))
    assert all(torch.equal(a, b) for a, b in zip(trace_shaded(s, vol, cam, **ages), want))
    e = dict(e, soft_shadow_samples=kw["soft_shadow_samples"],
             indirect_lighting=kw.get("indirect", False),
             indirect_bounces=kw.get("indirect_bounces", 1))
    got = frozen.sliced_trace(vol, cam, harness._lighting(e, sliced=True),
                              planes if aged else None, grid_size=N, width=W, height=H,
                              total_states=10)
    assert torch.equal(got[2], want[2]) and (want[2] >= 0).any()
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


def test_the_control_traces_a_grid_whose_indices_bfloat16_rounds():
    """At 512³ and above bfloat16 rounds the sweep's last cell index n − 1
    up to n: the control still gives a frame, with other hits."""
    n = 512
    vol = torch.zeros((n // 32, n, n), dtype=torch.int32)
    vol[:, n // 2 - 40 : n // 2 + 40, n // 2 - 40 : n // 2 + 40] = -1
    _, _, cam = _cam(degrees=30.0)
    cam[frozen.P_WIN : frozen.P_WIN + 2] = (16, 8)
    light = frozen.Lighting(soft_k=1)
    want = frozen.sliced_trace(vol, cam, light, grid_size=n, width=16, height=8)
    with frozen.precision(torch.bfloat16):
        got = frozen.sliced_trace(vol, cam, light, grid_size=n, width=16, height=8)
    assert (want[2] >= 0).any() and not torch.equal(got[2], want[2])


# ------------------------------------------------- candidate runs ---


CANDIDATES = {
    # the pyroclastic deployment's shape: 10 states, Moore, hard shadow, sliced
    "pyro.sliced": ("clustered-256", dict(RULES["pyroclastic"], grid_size=1024), True),
    # its K1 compose branch at 256³ and below
    "pyro.k1": ("clustered-256", dict(RULES["pyroclastic"]), False),
    # the binary sliced path
    "binary.sliced": ("clustered-256", dict(grid_size=512), True),
    # two-bounce GI: render_frame_fast a frame at 256³
    "pbr.fused": ("pbr-256", {}, False),
    # the sliced path's soft shadows and two-bounce GI on ages
    "pyro.sliced-gi": ("pbr-256", dict(RULES["pyroclastic"], grid_size=512), True),
    # the tick loop's sliced frames along the orbit
    "binary.sliced-orbit": ("clustered-256", dict(grid_size=512), True, "orbit-dense"),
}


def _bench(tmp_path, name, base, engine, traffic="pinned"):
    """A BENCHMARK.json of one cell ``name``: configuration ``base`` with
    ``engine`` settings over it, mix ``traffic``."""
    config = harness.load_json(harness.HERE / "configs" / f"{base}.json")
    config = dict(config, name="candidate", engine=dict(config["engine"], **engine))
    cfg_path = tmp_path / "candidate.json"
    cfg_path.write_text(json.dumps(config))
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    bench["configs"] = [dict(bench["configs"][0], name="candidate", file=str(cfg_path))]
    bench["workloads"] = [{"name": name, "config": "candidate", "traffic": traffic, "chips": 1,
                           "why": "a candidate"}]
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path


@pytest.fixture
def candidate(tmp_path, monkeypatch, request):
    """(cell name, BENCHMARK.json path) of a candidate; a sliced one renders
    its 32³ test grid through the sliced path, as the port does above
    256³."""
    name = request.param
    base, engine, sliced, *traffic = CANDIDATES[name]
    if sliced:
        from cellularautomatons3d_tpu_torch.render import renderer_fast
        monkeypatch.setattr(renderer_fast, "MAX_GRID", N // 2)
        monkeypatch.setattr(harness, "K1_MAX_GRID", N // 2)
    return name, _bench(tmp_path, name, base, engine, *traffic)


def _path(bench):
    cell = harness.load_cell(json.loads(bench.read_text())["workloads"][0]["name"], bench)
    return harness.frame_path(harness.engine_settings(cell.config, cell.mix, SEED, SMALL),
                              cell.mix["loop"])


@pytest.mark.parametrize("candidate", sorted(CANDIDATES), indirect=True)
def test_candidate_sound_run_is_exact(candidate, monkeypatch):
    """On the CPU the program's plain twins and the reference agree bit for
    bit on every reading of both answers, on the path the reference
    chose."""
    from cellularautomatons3d_tpu_torch import engine
    from cellularautomatons3d_tpu_torch.render import renderer_fast
    name, bench = candidate
    want = {"pyro.sliced": "sliced", "pyro.k1": "k1", "binary.sliced": "sliced",
            "pbr.fused": "k1_lit", "pyro.sliced-gi": "sliced", "binary.sliced-orbit": "sliced"}[name]
    assert _path(bench) == want
    calls = {"raytrace_sliced": 0, "render_frame_fast": 0}
    for fn, mods in (("raytrace_sliced", [renderer_fast]),
                     ("render_frame_fast", [renderer_fast, engine])):
        def counted(*a, _real=getattr(renderer_fast, fn), _fn=fn, **kw):
            calls[_fn] += 1
            return _real(*a, **kw)
        for mod in mods:
            monkeypatch.setattr(mod, fn, counted)
    rec, extra = run(name, bench_path=bench)
    assert (calls["raytrace_sliced"] > 0) == (want == "sliced")
    assert (calls["render_frame_fast"] > 0) == (want != "k1")
    assert rec["correct"], extra["readings"]
    assert len(extra["readings"]) == 2
    assert all(v == 0 for r in extra["readings"] for v in r.values()), extra["readings"]


@pytest.mark.parametrize("candidate", sorted(CANDIDATES), indirect=True)
def test_candidate_control_is_not_correct(candidate):
    name, bench = candidate
    rec, extra = run(name, bench_path=bench, control=torch.bfloat16)
    assert not rec["correct"], extra["readings"]


def _off_by_one(real, after):
    """The multi-state step with, from its ``after``-th call on, one dying
    cell's age off by one (bit 0 of the first dying cell flipped)."""
    calls = [0]

    def f(state, spec):
        out = real(state, spec)
        calls[0] += 1
        if calls[0] <= after or spec.total_states == 2:
            return out
        dying = ca.visible(out[1:])
        w = int(torch.nonzero(dying.reshape(-1))[0, 0])
        v = int(dying.reshape(-1)[w])
        bit = v & -v
        bit = bit - 2**32 if bit >= 2**31 else bit
        out = out.clone()
        out[0].reshape(-1)[w] ^= bit
        return out
    return f


@pytest.mark.parametrize("candidate", ["pyro.sliced", "pyro.k1"], indirect=True)
def test_an_age_off_by_one_is_caught(candidate, monkeypatch):
    from cellularautomatons3d_tpu_torch import engine
    from cellularautomatons3d_tpu_torch.render import renderer_fast
    name, bench = candidate
    start = SMALL["mix"]["start_generation"]
    for mod in (engine, renderer_fast):
        monkeypatch.setattr(mod, "step_packed", _off_by_one(
            mod.step_packed, start - 1 if mod is engine else 0))
    rec, extra = run(name, bench_path=bench)
    assert not rec["correct"], extra["readings"]
    assert extra["readings"][0]["state_words_differ"] > 0


@pytest.mark.parametrize("candidate", ["pyro.sliced", "pyro.k1"], indirect=True)
def test_a_frame_without_the_fade_is_caught(candidate, monkeypatch):
    from cellularautomatons3d_tpu_torch.render import render_fast, render_slab
    name, bench = candidate
    for mod in (render_fast, render_slab):
        monkeypatch.setattr(mod, "_age_fade", lambda age, s: torch.ones(age.shape))
    rec, extra = run(name, bench_path=bench)
    assert not rec["correct"], extra["readings"]
    assert rec["checks"]["frame_max_rel_diff"]["value"] > 1e-3


REFUSED = {
    "soft_shadows": ("clustered-256", dict(soft_shadow_samples=4, light_radius=0.08)),
    "one_bounce": ("pbr-256", dict(indirect_bounces=1)),
    "gi_temporal": ("pbr-256", dict(gi_temporal=True)),
    "gi_temporal_sliced": ("pbr-256", dict(gi_temporal=True, grid_size=512)),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_a_path_the_reference_leaves_out_is_refused_before_the_window(case, tmp_path,
                                                                       monkeypatch):
    """The fused loop's extended frame and the temporal lighting mode raise
    a named error before the Engine is built."""
    import cellularautomatons3d_tpu_torch as port
    base, engine = REFUSED[case]
    bench = _bench(tmp_path, "refused", base, engine)

    def no_engine(*a, **kw):
        raise AssertionError("the Engine was built")
    monkeypatch.setattr(port, "Engine", no_engine)
    with pytest.raises(harness.NotInReference):
        run("refused", bench_path=bench)
