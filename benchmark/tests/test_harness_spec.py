"""The benchmark's data: every cell finds its configuration, mix and
check by name, every name and unit keeps to the allowed characters, and
a configuration, a mix, a cell and a metric that the harness has not seen
load from new files alone."""

import json
import re

import pytest

from benchmark import spec
from conftest import HELD, load_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("workload", CELLS + sorted(HELD))
def test_cell_finds_its_files(workload):
    cell = load_cell(workload)
    if workload in CELLS:
        assert cell.config["name"] == next(
            w["config"] for w in BENCH["workloads"] if w["name"] == workload)
    assert {"width", "height", "camera", "teapot", "edits"} <= set(cell.traffic)
    assert set(cell.check) == {"frames", "limits"}
    assert set(cell.check["frames"]) <= {"start", "seeded", "after"}
    numbers = {"id_mismatch", "gbuffer_rel", "shading_rel", "output_rel",
               "state_rel", "state_words"}
    numbers |= {"hash_slots"} if cell.config["render"]["gi_cache"] == "hash" \
        else set()
    numbers |= {"scene_words"} if cell.traffic["edits"] else set()
    assert set(cell.check["limits"]) == numbers
    assert {m["name"] for m in cell.end_to_end} >= {"frame_ms_p95", "setup_s"}
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.metric_reader(m["name"]))


@pytest.mark.parametrize("workload", CELLS)
def test_per_layer_metrics_move_what_the_cell_reports(workload):
    """A cell's per-layer metrics each move one of its end-to-end metrics,
    and it reports one besides ``setup_s``."""
    cell = spec.load_cell(workload)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e, (workload, m["name"])


def test_a_split_metric_reads_as_its_base(tmp_path):
    """``<base>.<group>`` with no reader of its own reads as ``<base>``; a
    name with a reader of its own keeps it; an unknown base is an
    error."""
    metrics = tmp_path / "benchmark" / "metrics"
    metrics.mkdir(parents=True)
    (metrics / "frames_seen.py").write_text(
        "def read(run):\n    return float(run.frames)\n")
    (metrics / "frames_seen.own.py").write_text(
        "def read(run):\n    return -1.0\n")

    class Run:
        frames = 7

    read = spec.metric_reader("frames_seen.tail", tmp_path)
    assert read(Run()) == 7.0
    assert spec.metric_reader("frames_seen.own", tmp_path)(Run()) == -1.0
    with pytest.raises(FileNotFoundError):
        spec.metric_reader("frames_unseen.tail", tmp_path)


def test_names_and_units():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["config"] for w in BENCH["workloads"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"])
               for m in BENCH["end_to_end"] + BENCH["per_layer"])
    for text in ([c["source"] for c in BENCH["configs"]]
                 + [w["why"] for w in BENCH["workloads"]]
                 + [m["layer"] for m in BENCH["per_layer"]] + BENCH["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
    for c in BENCH["configs"]:
        assert (spec.ROOT / c["file"]).is_file()
        assert c["file"].startswith(BENCH["paths"][0] + "/")
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_new_config_mix_cell_and_metric_from_files_alone(tmp_path):
    """A cell of a configuration, a mix and a metric the harness has not
    seen, in a checkout of its own: it loads without an edit."""
    (tmp_path / "benchmark" / "configs").mkdir(parents=True)
    for sub in ("traffic", "checks", "metrics"):
        (tmp_path / "benchmark" / sub).mkdir()
    config = json.loads((spec.ROOT / "benchmark/configs/castle-dense.json")
                        .read_text())
    config["name"] = "castle-other"
    (tmp_path / "benchmark/configs/castle-other.json").write_text(
        json.dumps(config))
    mix = dict(spec.load_json(spec.HERE / "traffic/orbit-1080p.json"),
               width=2560, height=1440)
    (tmp_path / "benchmark/traffic/orbit-1440p.json").write_text(
        json.dumps(mix))
    (tmp_path / "benchmark/checks/other-orbit-1440p.json").write_text(
        json.dumps({"frames": ["start"], "limits": {"output_rel": 0.1}}))
    (tmp_path / "benchmark/metrics/frames_seen.py").write_text(
        "def read(run):\n    return float(run.frames)\n")
    # The new cell reports frame_ms: it joins the metric's list of cells.
    e2e = [dict(m, workloads=m["workloads"] + ["other-orbit-1440p"])
           if "workloads" in m else m for m in BENCH["end_to_end"]]
    bench = dict(BENCH, end_to_end=e2e, configs=[{
        "name": "castle-other", "source": "s", "why": "w", "reduced": [],
        "file": "benchmark/configs/castle-other.json"}], workloads=[{
        "name": "other-orbit-1440p", "config": "castle-other",
        "traffic": "orbit-1440p", "chips": 1, "why": "w"}], per_layer=[{
        "name": "frames_seen", "unit": "frames", "better": "higher",
        "source": "host_clock", "layer": "benchmark harness",
        "moves": "frame_ms"}])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("other-orbit-1440p", tmp_path)
    assert cell.traffic["width"] == 2560
    assert cell.config["name"] == "castle-other"
    assert [m["name"] for m in cell.per_layer] == ["frames_seen"]

    class Run:
        frames = 7

    assert spec.metric_reader("frames_seen", tmp_path)(Run()) == 7.0
