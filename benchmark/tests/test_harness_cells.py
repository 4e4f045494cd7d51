"""The benchmark's data: every cell's configuration, mix, metrics and kernel
families load by name, ``BENCHMARK.json`` keeps its documented shape, and a
run's record has the keys its result line documents."""

import importlib
import json
import re
import subprocess
import sys

import pytest

import harness
from _small import run

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    c = harness.load_cell(cell)
    assert c.mix["loop"] in harness.LOOPS
    assert c.config["name"] == c.entry["config"]
    assert set(c.config["limits"]) == set(harness.CHECK_KEYS)
    names = {m["name"] for m in c.end_to_end}
    assert {"frame_ms", "setup_s"} <= names
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        spec = json.loads((harness.HERE / "metrics" / f"{m['name']}.json").read_text())
        assert spec["name"] == m["name"] and spec["moves"] in names
        for key in ("layer", "unit", "better", "source", "workloads"):
            assert spec[key] == m[key], (m["name"], key)
        importlib.import_module(f"readers.{spec['reader']}")
    assert c.config["engine"]["grid_size"] == 256 and c.entry["chips"] == 1


def test_kernel_families_count_launches():
    launched = harness.counters()
    assert "render_kernel" in launched and "ca_step_kernel" in launched
    assert all(isinstance(n, int) for n in launched.values())


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and BENCH["command"][1].startswith("benchmark/")
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert c["source"].startswith("https://") and len(c["source"]) <= 200
    sources = [c["source"] for c in BENCH["configs"]]
    assert len(set(sources)) == len(sources)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                   "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("trace", [False, True])
def test_record_has_the_result_keys(trace):
    rec, _ = run("clustered256.pinned", trace=trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    if trace:
        keys.append("breakdown")
    assert list(rec) == keys + ["checks"]
    assert rec["correct"] is True and rec["failed"] == 0 and rec["attempted"] > 0
    assert set(rec["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(rec["device"])
        assert set(rec["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(rec["metrics"]) == {"frame_ms", "setup_s"}
    for c in rec["checks"].values():
        assert set(c) == {"value", "limit"}
    json.loads(json.dumps(rec))


def test_without_a_card_the_command_prints_nothing():
    if importlib.import_module("torch").cuda.is_available():
        pytest.skip("a card is present: the command runs the cell")
    p = subprocess.run([sys.executable, str(harness.HERE / "run.py"), "--workload",
                        "clustered256.pinned", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_an_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        harness.load_cell("no.such.cell")


@pytest.mark.parametrize("j, want", [(0, (0, 0)), (1, (0, 0)), (2, (0, 1)), (3, (1, 0)),
                                      (29, (9, 1)), (30, (0, 0)), (32, (0, 1)), (35, (1, 1))])
def test_tick_cadence(j, want):
    assert harness.tick_generation(j, 16.667, 48.0, 30) == want


def test_orbit_starts_at_the_initial_view():
    pose = harness.orbit_pose(0.0, 0.75, 0.0)
    want = [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0.75], [0, 0, 0, 1]]
    assert pose.tolist() == want
    from cellularautomatons3d_tpu_torch.utils import mat4
    assert (mat4.initial_view_matrix() == pose).all()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card_is_correct(cell):
    if not importlib.import_module("torch").cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, str(harness.HERE / "run.py"), "--workload", cell,
                        "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    rec = json.loads(p.stdout.strip().splitlines()[-1])
    assert rec["correct"] and rec["device"]["platform"] == "gpu", rec
