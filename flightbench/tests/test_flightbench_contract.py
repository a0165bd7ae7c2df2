"""BENCHMARK.json against the benchmark's contract, and the harness's
imports: every name, unit and file; what each cell reports; no JAX."""

from __future__ import annotations

import ast
import json
import os
import re

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH_DIR)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert os.path.isdir(os.path.join(ROOT, p))
    cmd = bench["command"]
    assert 1 <= len(cmd) <= 32 and all(line(w) for w in cmd)
    for w in cmd[1:]:
        if "/" in w:
            assert any(w == p or w.startswith(p + "/") for p in bench["paths"]), w
            assert os.path.exists(os.path.join(ROOT, w))


def test_run_seconds_fit_24_cells(bench):
    rs = bench["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units(bench):
    entries = bench["configs"] + bench["workloads"] + bench["end_to_end"] + bench["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[group]]
        assert len(names) == len(set(names)), group
    metric_names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_entry_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line(c["source"]) and line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and line(w["why"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert line(m["layer"])
    assert 1 <= len(bench["configs"]) <= 24 and 1 <= len(bench["workloads"]) <= 24
    assert 1 <= len(bench["end_to_end"]) <= 16 and 1 <= len(bench["per_layer"]) <= 128


def test_files_of_each_name_exist(bench):
    for c in bench["configs"]:
        assert c["file"].startswith("flightbench/") and os.path.isfile(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in bench["workloads"]:
        cell_file = os.path.join(BENCH_DIR, "cells", f"{w['name']}.json")
        with open(cell_file) as f:
            cell = json.load(f)
        assert os.path.isfile(os.path.join(BENCH_DIR, "drivers", f"{cell['driver']}.py"))
        assert os.path.isfile(os.path.join(BENCH_DIR, "mixes", f"{w['traffic']}.json"))
        assert cell["check"]["limits"], w["name"]
    for m in bench["per_layer"]:
        assert os.path.isfile(os.path.join(BENCH_DIR, "metrics", f"{m['name']}.py")), m["name"]


def test_every_cell_reports_what_it_must(bench):
    e2e = bench["end_to_end"]
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in e2e)
    for w in bench["workloads"]:
        reported = {m["name"] for m in e2e if w["name"] in m.get("workloads", [w["name"]])}
        assert "setup_s" in reported and len(reported) >= 2, w["name"]
        layer = [m for m in bench["per_layer"] if w["name"] in m["workloads"]]
        assert layer, w["name"]


def test_each_per_layer_metric_moves_what_its_cells_report(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        assert m["workloads"], m["name"]  # the harness picks a cell's per-layer metrics by this key alone
        for cell in m["workloads"]:
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", [cell]), (m["name"], cell)


def test_layer_names_are_one_spelling(bench):
    names = {m["layer"] for m in bench["per_layer"]}
    assert len({" ".join(n.lower().split()) for n in names}) == len(names)


def test_at_most_a_quarter_of_cells_on_four_chips(bench):
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)


def test_file_names_are_made_of_name_characters():
    for base, _, files in os.walk(BENCH_DIR):
        if "__pycache__" in base:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(base, f), ROOT)
            assert PATH.match(rel), rel


def _modules(folder):
    for base, _, files in os.walk(folder):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def _imported_top_names(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_nothing_under_the_benchmark_imports_jax():
    forbidden = {"jax", "jaxlib", "flax", "learningagileflight_se3_tpu"}
    for path in _modules(BENCH_DIR):
        assert not (_imported_top_names(path) & forbidden), path


def test_the_reference_imports_nothing_of_the_port():
    for path in _modules(os.path.join(BENCH_DIR, "reference")):
        names = _imported_top_names(path)
        assert "learningagileflight_se3_torch" not in names, path
        assert not any(n.startswith("learningagileflight") for n in names), path


def test_nothing_reads_the_jax_benchmarks_folder():
    for path in _modules(BENCH_DIR):
        if os.path.samefile(path, __file__):
            continue
        assert "benchmarks" not in _imported_top_names(path), path
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        docs = {id(n.body[0].value) for n in ast.walk(tree)
                if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef)) and n.body
                and isinstance(n.body[0], ast.Expr) and isinstance(n.body[0].value, ast.Constant)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str) and id(node) not in docs:
                assert not node.value.startswith("benchmarks"), (path, node.value)
