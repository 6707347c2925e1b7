"""BENCHMARK.json against the contract the harness is built to, and every
file it names found by name."""

import json
import os
import re

from portbench import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def bench():
    return run.manifest()


def test_top_level_keys_and_sizes(repo_root):
    b = bench()
    assert set(b) == TOP
    assert os.path.getsize(os.path.join(repo_root, "BENCHMARK.json")) \
        <= 64 * 1024
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert b["paths"] == ["portbench"]
    assert len(b["command"]) <= 32
    for word in b["command"]:
        assert not word.startswith("/") and ".." not in word


def test_names_units_and_text():
    b = bench()
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in b[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            for k in ("why", "layer", "source"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] \
                        and "\t" not in e[k]
    assert len(names) == len(set(names))
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_entry_keys():
    b = bench()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert NAME.match(w["traffic"])
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_cell_resolves_its_files():
    b = bench()
    used = set()
    for w in b["workloads"]:
        files = run.cell_files(b, w["name"])
        used.add(w["config"])
        traffic = run.kind(files["mix"]["kind"])
        assert callable(traffic.drive) and callable(traffic.judge)
        e2e = {m["name"] for m in files["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert files["per_layer"]
        for m in files["end_to_end"] + files["per_layer"]:
            assert callable(run.reader(m["name"]))
        assert files["limits"]
    assert used == {c["name"] for c in b["configs"]}


def test_config_files_are_their_own(repo_root):
    b = bench()
    files = [c["file"] for c in b["configs"]]
    assert len(files) == len(set(files))
    for c in b["configs"]:
        assert c["file"].startswith("portbench/")
        with open(os.path.join(repo_root, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]


def test_per_layer_metrics_name_their_cells_and_one_mover():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    cells = {w["name"] for w in b["workloads"]}
    layers = {}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert m["workloads"] and set(m["workloads"]) <= cells
        reported = e2e[m["moves"]].get("workloads", sorted(cells))
        assert set(m["workloads"]) <= set(reported)
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    # metrics of one quantity sit on one layer, named letter for letter
    assert all(len(v) == 1 for v in layers.values())


def test_files_under_paths_are_named_from_name_characters(repo_root):
    ok = re.compile(r"^[A-Za-z0-9_.-]+$")
    for dirpath, dirs, files in os.walk(os.path.join(repo_root,
                                                     "portbench")):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files + dirs:
            assert ok.match(f), f
