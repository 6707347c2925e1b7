"""Kinds of traffic are found by file: a configuration whose traffic is a
new kind is added as new files (a module in kinds/, a mix, limits, a
reader), with no edit to a file the harness has; a mix that names no
kind present stops the run before the chip check."""

import json
import os
import shutil

import pytest

from portbench import run
from portbench.tests.conftest import run_tiny

TOY = '''"""A toy kind: the int64 sum of each of a few tracks, over and over."""

import time

import numpy as np

from portbench import corpus


def drive(cell):
    mix = cell.mix
    x = corpus.tracks(int(mix["tracks"]), float(mix["track_s"]),
                      corpus.generator(cell.seed, cell.device), cell.device)
    sums = []
    t0 = cell.open_window()
    while not sums or time.perf_counter() < t0 + cell.seconds:
        sums.append(x.long().sum(dim=1))
    return {"window_s": time.perf_counter() - t0, "sums": len(sums),
            "attempted": len(sums), "failed": 0,
            "outputs": lambda: {"sums": sums[-1].cpu().numpy()},
            "inputs": {"tracks": x.cpu().numpy()}, "release": sums.clear}


def judge(outputs, inputs, device):
    want = inputs["tracks"].astype(np.int64).sum(axis=1)
    return {"toy_sum_gap": float(np.max(np.abs(outputs["sums"] - want)))}
'''

READER = '''def read(rec):
    return rec["sums"] / rec["window_s"] if "sums" in rec else None
'''


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """A copy of the harness that run.py reads its files from."""
    here = tmp_path / "portbench"
    shutil.copytree(run.HERE, here, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    monkeypatch.setattr(run, "HERE", str(here))
    return here


def _add(tree, files: dict) -> None:
    for rel, text in files.items():
        path = tree / rel
        assert not path.exists(), rel
        path.write_text(text)


def _bench_with(cell: dict, e2e: list = ()) -> dict:
    bench = run.manifest()
    bench["workloads"].append(cell)
    bench["end_to_end"] += list(e2e)
    return bench


def test_a_new_kind_is_new_files(tree):
    _add(tree, {"kinds/toy.py": TOY,
                "mixes/toy_4x1.json": json.dumps(
                    {"kind": "toy", "tracks": 4, "track_s": 1.0}),
                "limits/c2-1k.toy.json": json.dumps({"toy_sum_gap": 0}),
                "metrics/toy_sums_per_s.py": READER})
    bench = _bench_with(
        {"name": "c2-1k.toy", "config": "c2-1k", "traffic": "toy_4x1",
         "chips": 1, "why": "toy"},
        [{"name": "toy_sums_per_s", "unit": "sums/s", "better": "higher",
          "bound": 0.25, "source": "host_clock", "workloads": ["c2-1k.toy"]}])
    line = run_tiny(run.cell_files(bench, "c2-1k.toy"), seconds=0.2)
    assert line["checks"] == {"toy_sum_gap": {"value": 0.0, "limit": 0}}
    assert line["correct"] and line["attempted"] > 0
    assert set(line["metrics"]) == {"setup_s", "toy_sums_per_s"}
    assert line["metrics"]["toy_sums_per_s"]["value"] > 0


def test_an_unknown_kind_stops_before_the_chip_check(tree, monkeypatch,
                                                     capsys):
    _add(tree, {"mixes/nope_1.json": json.dumps({"kind": "nope"}),
                "limits/c2-1k.nope.json": "{}"})
    bench = _bench_with({"name": "c2-1k.nope", "config": "c2-1k",
                         "traffic": "nope_1", "chips": 1, "why": "nope"})
    with pytest.raises(SystemExit) as e:
        run.cell_files(bench, "c2-1k.nope")
    for word in ("'nope'", "'backlog'", "'ingest'"):
        assert word in str(e.value)

    def no_chip_check(chips):
        raise AssertionError("the chip was looked for")
    monkeypatch.setattr(run, "manifest", lambda: bench)
    monkeypatch.setattr(run, "check_chip", no_chip_check)
    with pytest.raises(SystemExit):
        run.main(["--workload", "c2-1k.nope", "--seed", "5",
                  "--seconds", "1"])
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("name", ["nope", "../drive", "drive", ""])
def test_kind_names_only_modules_in_kinds(name):
    with pytest.raises(SystemExit) as e:
        run.kind(name)
    assert "'backlog'" in str(e.value) and "'ingest'" in str(e.value)


@pytest.mark.parametrize("mix", sorted(os.listdir(os.path.join(
    run.HERE, "mixes"))))
def test_every_mix_names_a_kind_with_a_driver_and_a_judge(mix):
    traffic = run.kind(run.load_json(os.path.join(run.HERE, "mixes",
                                                  mix))["kind"])
    assert callable(traffic.drive) and callable(traffic.judge)
    assert callable(traffic.control)
