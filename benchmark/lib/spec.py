"""The cell's files, found by name: ``BENCHMARK.json`` names each cell's
configuration and traffic mix; ``benchmark/configs/<config>.json`` (the
file the configuration's entry names), ``benchmark/traffic/<mix>.json``,
``benchmark/kinds/<kind>.py`` and ``benchmark/metrics/<metric>.py`` hold
the rest. A new cell, configuration, mix or metric is a new file and a new
entry: nothing here names one."""

import importlib
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def read_json(path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


class Spec:
    """``BENCHMARK.json`` of the checkout at ``root`` and the files it
    names."""

    def __init__(self, root=ROOT):
        self.root = Path(root)
        self.bench = read_json(self.root / "BENCHMARK.json")

    def cell(self, name):
        """(workload entry, configuration entry, configuration file's
        contents, traffic mix's contents) of the cell ``name``."""
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                           f"{sorted(cells)}")
        cell = cells[name]
        configs = {c["name"]: c for c in self.bench["configs"]}
        entry = configs[cell["config"]]
        config = read_json(self.root / entry["file"])
        mix = read_json(self.root / "benchmark" / "traffic"
                        / f"{cell['traffic']}.json")
        return cell, entry, config, mix

    def metrics(self, cell_name, section):
        """The entries of ``section`` (``end_to_end`` or ``per_layer``)
        that cell ``cell_name`` reports: those with no ``workloads`` key
        and those whose ``workloads`` list it."""
        return [m for m in self.bench[section]
                if cell_name in m.get("workloads", [cell_name])]

    def reader(self, metric_name):
        """``read(ctx)`` of ``benchmark/metrics/<metric_name>.py``: the
        metric's value, or None where the run has nothing to read."""
        path = self.root / "benchmark" / "metrics" / f"{metric_name}.py"
        spec = importlib.util.spec_from_file_location(
            "benchmark_metric_" + metric_name.replace(".", "_"), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


def kind_module(kind):
    """The module of a traffic kind, ``benchmark/kinds/<kind>.py``."""
    return importlib.import_module(f"benchmark.kinds.{kind}")
