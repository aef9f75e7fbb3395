"""BENCHMARK.json against the benchmark's contract, and the files it names;
what the harness and the reference load."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    SPEC = json.load(_f)


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert (runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200
            <= 43200)
    assert len(json.dumps(SPEC)) <= 64 * 1024


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in SPEC[group]:
            yield group, e


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_and_units(group):
    names = [e["name"] for e in SPEC[group]]
    assert len(names) == len(set(names))
    for e in SPEC[group]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and group != "end_to_end":
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]


def test_cells_name_their_files():
    configs = {c["name"]: c for c in SPEC["configs"]}
    used = set()
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
        with open(os.path.join(BENCH, "workloads", w["name"] + ".json")) as f:
            traffic = json.load(f)
        assert (traffic["config"], traffic["traffic"]) == (w["config"],
                                                           w["traffic"])
        assert traffic["mode"] in ("serve", "request", "train")
        assert traffic["limits"]
    assert used == set(configs)
    for c in configs.values():
        assert c["file"].startswith("benchmark/")
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["flags"]


def test_metrics_have_readers_and_cells():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or cell in moved["workloads"]
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))
    for cell in cells:
        reported = [m for m in e2e.values()
                    if "workloads" not in m or cell in m["workloads"]]
        assert len(reported) >= 2
        assert any(cell in m["workloads"] for m in SPEC["per_layer"])


def _loaded(code: str):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_the_reference_loads_nothing_of_the_port_or_jax():
    tops = _loaded(
        "import json, sys; sys.path.insert(0, '.');"
        "import benchmark.reference.model, benchmark.reference.train;"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not tops & {"cocosnet_tpu_torch", "cocosnet_tpu", "jax",
                       "jaxlib", "flax"}


def test_the_harness_loads_no_jax():
    tops = _loaded(
        "import json, sys; sys.path.insert(0, '.');"
        "import benchmark.run, benchmark.calibrate, benchmark.program;"
        "from benchmark import program;"
        "program.serve_step; import cocosnet_tpu_torch.tools.serve,"
        " cocosnet_tpu_torch.train.steps, cocosnet_tpu_torch.cli.common;"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "cocosnet_tpu_torch" in tops
    assert not tops & {"cocosnet_tpu", "jax", "jaxlib", "flax"}


def test_forbidden_names_are_whole_top_level_names():
    sys.path.insert(0, ROOT)
    from benchmark import run
    saved = dict(sys.modules)
    try:
        for name in ("cocosnet_tpu", "jax", "flax", "jaxlib"):
            sys.modules.pop(name, None)
        sys.modules.setdefault("cocosnet_tpu_torch", object())
        sys.modules["jax_free_module"] = object()
        assert run.forbidden_modules() == []
        sys.modules["cocosnet_tpu.config"] = object()
        assert run.forbidden_modules() == ["cocosnet_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
