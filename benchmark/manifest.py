"""BENCHMARK.json and the files the harness finds by name: a cell's traffic
file benchmark/workloads/<cell>.json, a configuration's file
benchmark/configs/<config>.json, a per-layer metric's reader
benchmark/metrics/<metric>.py."""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List


class Manifest:
    def __init__(self, root: str):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.data = json.load(f)
        self.here = os.path.join(root, "benchmark")
        self._readers: Dict[str, object] = {}

    def _json(self, *parts) -> dict:
        with open(os.path.join(self.here, *parts)) as f:
            return json.load(f)

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise SystemExit(f"no cell {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        entry = next(c for c in self.data["configs"] if c["name"] == name)
        with open(os.path.join(self.root, entry["file"])) as f:
            return json.load(f)

    def traffic(self, name: str, entry: dict) -> dict:
        t = self._json("workloads", name + ".json")
        if (t["config"], t["traffic"]) != (entry["config"], entry["traffic"]):
            raise SystemExit(f"{name}: its traffic file names "
                             f"{t['config']}/{t['traffic']}, BENCHMARK.json "
                             f"{entry['config']}/{entry['traffic']}")
        return t

    @staticmethod
    def _in(metric: dict, cell: str) -> bool:
        return "workloads" not in metric or cell in metric["workloads"]

    def end_to_end(self, cell: str) -> List[dict]:
        return [m for m in self.data["end_to_end"] if self._in(m, cell)]

    def per_layer(self, cell: str) -> List[dict]:
        """The per-layer metrics of the cell: those listing it, and those
        without a list whose end-to-end metric the cell reports."""
        reported = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.data["per_layer"]
                if cell in m.get("workloads", ())
                or ("workloads" not in m and m["moves"] in reported)]

    def reader(self, metric: str):
        if metric not in self._readers:
            path = os.path.join(self.here, "metrics", metric + ".py")
            spec = importlib.util.spec_from_file_location(
                "benchmark.metrics." + metric.replace(".", "_"), path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._readers[metric] = mod
        return self._readers[metric]
