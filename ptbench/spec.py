"""``BENCHMARK.json`` and the files it names, found by name.

* a configuration: ``ptbench/configs/<name>.json``;
* a traffic mix: ``ptbench/workloads/<traffic>.json``;
* a per-layer metric: ``ptbench/metrics/<name>.py``, a module with
  ``read(ctx)`` that returns the metric's value or None.

A cell reports the end-to-end metrics that list it under ``workloads`` or
have no such list, and the per-layer metrics that list it, or that have no
list and move an end-to-end metric it reports.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json"), encoding="utf-8") as f:
        bench = json.load(f)
    validate(bench)
    return bench


def validate(bench: dict) -> None:
    """Raise ValueError on a name or unit outside the allowed characters,
    or on a name given twice."""
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench.get(section, []):
            names.append((section, entry["name"]))
            keys = [entry["name"]]
            if section == "workloads":
                keys += [entry["config"], entry["traffic"]]
            if section == "configs":
                keys += list(entry.get("reduced", []))
            for key in keys:
                if not NAME.match(key):
                    raise ValueError(f"{section}: bad name {key!r}")
            if "unit" in entry and not UNIT.match(entry["unit"]):
                raise ValueError(f"{section}: bad unit {entry['unit']!r} of {entry['name']!r}")
    metric_names = [n for s, n in names if s in ("end_to_end", "per_layer")]
    for group in (metric_names, [n for s, n in names if s == "configs"],
                  [n for s, n in names if s == "workloads"]):
        if len(group) != len(set(group)):
            raise ValueError(f"a name is given twice among {group}")


def _json(*parts) -> dict:
    with open(os.path.join(*parts), encoding="utf-8") as f:
        return json.load(f)


def cell(bench: dict, name: str, root: str = ROOT) -> dict:
    """The cell ``name``: its entry, configuration, traffic and metrics."""
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[0]
    conf_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [
        m for m in bench["per_layer"]
        if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)
    ]
    return {
        "entry": entry,
        "config": _json(root, conf_entry["file"]),
        "traffic": _json(root, "ptbench", "workloads", entry["traffic"] + ".json"),
        "end_to_end": e2e,
        "per_layer": per_layer,
    }


def reader(metric: str, root: str = ROOT):
    """The module of ``ptbench/metrics/<metric>.py``."""
    path = os.path.join(root, "ptbench", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location("ptbench_metric_" + metric.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
