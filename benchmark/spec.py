"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of
the checkout, each configuration's file (``configs[].file``), each
traffic mix (``benchmark/traffic/<traffic>.json``), each cell's check
(the frames it checks and each number's limit,
``benchmark/checks/<workload>.json``) and each metric's reader
(``benchmark/metrics/<name>.py``, a ``read(run)`` function). Adding a
configuration, a mix, a cell or a metric adds files and entries and
edits none. A metric with no ``workloads`` list is reported in every
cell; a per-layer one, in every cell that reports the end-to-end metric
it ``moves``.

A configuration whose file has ``"parallel": {"shard": "rays"}`` runs
its cells ray-sharded: one process per card, ``chips`` ranks, the
program's sharded frame (``benchmark/ranks.py``)."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    check: dict
    end_to_end: list
    per_layer: list

    @property
    def sharded(self) -> bool:
        """Whether the cell runs ray-sharded over ``chips`` ranks."""
        return "parallel" in self.config


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, workload: str, reported=None) -> bool:
    """Whether ``metric`` is reported in ``workload``: in the cells it
    lists; with no list, in every cell, or, for a per-layer metric (given
    the cell's end-to-end names ``reported``), in every cell that reports
    the end-to-end metric it moves."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return reported is None or metric["moves"] in reported


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``; raises KeyError
    when there is none."""
    bench = load_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"]
                     if c["name"] == entry["config"])
    return make_cell(workload, entry["chips"], cfg_entry["file"],
                     entry["traffic"], root)


def make_cell(workload: str, chips: int, config_file: str, traffic: str,
              root: Path = ROOT) -> Cell:
    """A cell from its files: the configuration's file (relative to
    ``root``), the mix ``benchmark/traffic/<traffic>.json`` and the check
    ``benchmark/checks/<workload>.json``, with the metrics of
    ``root/BENCHMARK.json`` that apply to it."""
    bench = load_json(root / "BENCHMARK.json")
    data = root / "benchmark"
    end_to_end = [m for m in bench["end_to_end"] if _applies(m, workload)]
    reported = {m["name"] for m in end_to_end}
    cell = Cell(
        name=workload, chips=chips, config=load_json(root / config_file),
        traffic=load_json(data / "traffic" / f"{traffic}.json"),
        check=load_json(data / "checks" / f"{workload}.json"),
        end_to_end=end_to_end,
        per_layer=[m for m in bench["per_layer"]
                   if _applies(m, workload, reported)])
    parallel = cell.config.get("parallel")
    if parallel is not None and parallel != {"shard": "rays"}:
        raise ValueError(f"{config_file}: \"parallel\" is {parallel!r}; the "
                         f"harness runs {{\"shard\": \"rays\"}} alone")
    if cell.sharded and cell.traffic["edits"]:
        raise ValueError(f"cell {workload}: a ray-sharded configuration "
                         f"with edits ({traffic}) is not run; the harness "
                         f"drives the scene editor on one card only")
    return cell


def metric_reader(name: str, root: Path = ROOT):
    """The ``read(run)`` function of metric ``name``, in
    ``root/benchmark/metrics/<name>.py``. A name ``<base>.<group>`` with
    no file of its own reads as ``<base>``: one quantity split by the
    end-to-end metric it moves in a group of cells."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    if not path.is_file() and "." in name:
        return metric_reader(name.rsplit(".", 1)[0], root)
    module_spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name}", path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module.read


def render_settings(settings_cls, config: dict, traffic: dict):
    """``settings_cls`` (a ``RenderSettings`` dataclass) at the traffic's
    resolution with the configuration's ``render`` entries: a nested
    dict sets the fields of the nested dataclass of that name."""
    def build(cls, values: dict):
        fields = {f.name: f for f in dataclasses.fields(cls)}
        kw = {}
        for key, value in values.items():
            if key not in fields:
                raise KeyError(f"{cls.__name__} has no field {key!r}")
            if isinstance(value, dict):
                sub = type(getattr(cls(), key))
                value = build(sub, value)
            elif isinstance(value, list):
                value = tuple(value)
            kw[key] = value
        return cls(**kw)

    values = dict(config["render"], width=traffic["width"],
                  height=traffic["height"])
    return build(settings_cls, values)
