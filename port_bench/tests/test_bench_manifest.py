"""``BENCHMARK.json`` against the benchmark's contract, and every file it
names found by name."""

from __future__ import annotations

import os
import re
import subprocess

import pytest
from conftest import ROOT, load

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
E2E_SOURCES = {"host_clock", "device_trace"}
SOURCES = E2E_SOURCES | {"program_span", "program_counter"}


@pytest.fixture(scope="module")
def manifest():
    return load("BENCHMARK.json")


def line(text) -> bool:
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and \
        "\t" not in text


def test_shape_and_sizes(manifest):
    assert set(manifest) == KEYS["top"]
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(manifest["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p.split("/") for p in manifest["paths"])
    assert 1 <= len(manifest["command"]) <= 32 and all(line(w) for w in manifest["command"])
    assert 1 <= manifest["run_seconds"] <= 51 and isinstance(manifest["run_seconds"], int)
    assert 1 <= len(manifest["configs"]) <= 24
    assert 1 <= len(manifest["workloads"]) <= 24
    assert 1 <= len(manifest["end_to_end"]) <= 16
    assert 1 <= len(manifest["per_layer"]) <= 128


def test_run_seconds_fit_a_full_check(manifest):
    """2 + 14 runs a cell at the full 24 cells, run_seconds + 60 each, 2 x 90
    s of compiling a cell and 1200 s spare fit into 43200 s."""
    rs = manifest["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_keys(manifest):
    names = []
    for c in manifest["configs"]:
        assert set(c) == KEYS["config"]
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith(tuple(p + "/" for p in manifest["paths"]))
    for w in manifest["workloads"]:
        assert set(w) == KEYS["workload"]
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and line(w["why"])
    for kind in ("end_to_end", "per_layer"):
        for m in manifest[kind]:
            assert set(m) - {"workloads"} == KEYS[kind], m["name"]
            assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m["name"]
            assert m["better"] in ("lower", "higher")
            assert m["source"] in (E2E_SOURCES if kind == "end_to_end" else SOURCES)
            names.append(m["name"])
    for m in manifest["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert line(m["layer"])
        # Each lists its cells: the harness reads a metric only where it is listed.
        assert m.get("workloads"), m["name"]
        assert set(m["workloads"]) <= {w["name"] for w in manifest["workloads"]}, m["name"]
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(names) == len(set(names))
    assert len({w["name"] for w in manifest["workloads"]}) == len(manifest["workloads"])
    assert len({(w["config"], w["traffic"]) for w in manifest["workloads"]}) == \
        len(manifest["workloads"])
    assert sum(w["chips"] == 4 for w in manifest["workloads"]) <= 1


def test_every_cell_finds_its_files(manifest):
    from port_bench import run

    configs = {c["name"] for c in manifest["configs"]}
    for w in manifest["workloads"]:
        assert w["config"] in configs
        files = run.cell_files(manifest, w["name"])
        for key in ("config", "traffic", "limits"):
            assert os.path.isfile(files[key]), files[key]
        kind = load(files["traffic"])["kind"]
        assert os.path.isfile(os.path.join(ROOT, "port_bench", "drivers", kind + ".py"))
    for c in manifest["configs"]:
        assert load(c["file"])["name"] == c["name"]
        assert any(w["config"] == c["name"] for w in manifest["workloads"])


def test_every_cell_reports_what_it_must(manifest):
    from port_bench import run

    for w in manifest["workloads"]:
        e2e = {m["name"] for m in run.end_to_end(manifest, w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        layer = run.layer_metrics(manifest, w["name"])
        assert layer, w["name"]
        assert all(m["moves"] in e2e for m in layer), w["name"]
    for m in manifest["per_layer"]:
        path = os.path.join(ROOT, "port_bench", "layer_metrics", m["name"] + ".py")
        mod = run.load_file_module(path, "t_" + m["name"].replace(".", "_"))
        assert callable(mod.read)
    e2e_names = {m["name"] for m in manifest["end_to_end"]}
    assert all(m["moves"] in e2e_names for m in manifest["per_layer"])


def test_split_metrics_keep_their_layer(manifest):
    """A quantity split by the end-to-end metric it moves (``mfu.sample``,
    ``mfu.train``) names one layer, letter for letter."""
    layers = {}
    for m in manifest["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


def test_configs_are_the_published_ones(manifest):
    """Each configuration runs the repository's config files unchanged
    (``reduced`` is empty: full widths and depth)."""
    for c in manifest["configs"]:
        cfg = load(c["file"])
        assert c["reduced"] == cfg["reduced"] == []
        roles = list(cfg["models"])
        for role, path in zip(roles, cfg["files"]):
            assert cfg["models"][role] == load(path), path


def test_limits_cover_every_reading():
    for name in os.listdir(os.path.join(ROOT, "port_bench", "limits")):
        limits = load("port_bench", "limits", name)
        assert limits and all(isinstance(v, (int, float)) and v >= 0 for v in limits.values())


def test_no_file_of_the_benchmark_is_ignored():
    """``.gitignore`` drops no file under port_bench (its ``metrics/`` rule
    would drop a folder of that name)."""
    if not os.path.isdir(os.path.join(ROOT, ".git")):
        pytest.skip("not a git checkout")
    files = []
    for d, _, fs in os.walk(os.path.join(ROOT, "port_bench")):
        if "__pycache__" in d:
            continue
        files += [os.path.relpath(os.path.join(d, f), ROOT) for f in fs if not f.endswith(".pyc")]
    out = subprocess.run(["git", "check-ignore", "--no-index", *files], cwd=ROOT,
                         capture_output=True, text=True)
    assert out.stdout.strip() == ""
