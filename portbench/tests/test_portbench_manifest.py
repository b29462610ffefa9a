"""BENCHMARK.json against the rules a benchmark manifest keeps, and every
name in it against its file under portbench/."""

import json
import os
import re

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.fixture(scope="module")
def manifest():
    return harness.load_manifest()


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level_keys_and_size(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_command_and_paths(manifest):
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert 1 <= len(manifest["command"]) <= 32 and all(line(w) for w in manifest["command"])
    for word in manifest["command"]:
        if os.path.exists(os.path.join(harness.ROOT, word)):
            assert any(word == p or word.startswith(p + "/") for p in manifest["paths"])


def test_run_seconds_fit_a_full_check_of_24_cells(manifest):
    s = manifest["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(manifest, kind):
    names = [e["name"] for e in manifest[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names), names


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metric_entries(manifest, kind):
    for m in manifest[kind]:
        allowed = {"name", "unit", "better", "source", "workloads"}
        allowed |= {"bound"} if kind == "end_to_end" else {"layer", "moves"}
        required = allowed - {"workloads"} if kind == "end_to_end" else allowed
        assert set(m) <= allowed and required <= set(m), m
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if kind == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert m["source"] in SOURCES and line(m["layer"])
        cells = {w["name"] for w in manifest["workloads"]}
        assert set(m.get("workloads", [])) <= cells


def test_configs(manifest):
    used = {w["config"] for w in manifest["workloads"]}
    files = set()
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and line(c["source"]) and line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in manifest["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        with open(os.path.join(harness.ROOT, c["file"])) as f:
            body = json.load(f)
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert body["source"] == c["source"]
        for key in c["reduced"]:
            assert key in body and key in body["assumed"]
            assert not key.endswith(("_dim", "_rank")) and "hidden" not in key


def test_workloads_and_their_files(manifest):
    configs = {c["name"] for c in manifest["configs"]}
    pairs = set()
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and NAME.match(w["traffic"]) and line(w["why"])
        assert w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = harness.load_cell(manifest, w["name"])
        assert cell["why"] == w["why"]
        traffic = harness.load_json("traffic", w["traffic"])
        assert os.path.exists(os.path.join(harness.HERE, "loops", f"{traffic['loop']}.py"))
    four = sum(w["chips"] == 4 for w in manifest["workloads"])
    assert four <= max(1, len(manifest["workloads"]) // 4)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer(manifest):
    assert "setup_s" in {m["name"] for m in manifest["end_to_end"]}
    for w in manifest["workloads"]:
        e2e = [m["name"] for m in manifest["end_to_end"] if harness.applies(m, w["name"])]
        layers = [m for m in manifest["per_layer"] if w["name"] in m["workloads"]]
        assert "setup_s" in e2e and len(e2e) >= 2 and layers, w["name"]
        for m in layers:
            assert m["moves"] in e2e, (m["name"], w["name"])


def test_every_metric_has_its_reader_and_every_group_its_words(manifest):
    for m in manifest["per_layer"]:
        assert callable(harness.reader(m["name"]))
    from portbench import timing

    groups = timing.kernel_groups()
    assert len({g["name"] for g in groups}) == len(groups)
    assert all(g["words"] and all(w == w.lower() for w in g["words"]) for g in groups)
