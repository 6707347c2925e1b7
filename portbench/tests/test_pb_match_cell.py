"""The c3-noisy.match cell as BENCHMARK.json lists it (test_pb_manifest.py
holds every cell's entries to the contract): its files load without a
chip with a reader for each metric, match_qps is reported in this cell
alone, its configuration is c2-1k's DB with the config-3 queries, and a
run of its own files, cut to CPU size, comes out correct, and not correct
with an answer altered where the program produces it or with the
bfloat16 control in the program's place."""

import os

from portbench import control, run
from portbench.tests.conftest import (BACKLOG_LIMITS, CONDITIONS, SEED,
                                      run_tiny, tiny)

CELL = "c3-noisy.match"


def _files():
    return run.cell_files(run.manifest(), CELL)


def _cpu_files():
    """The cell's own files at the sizes conftest.tiny gives a CPU run:
    c2-1k's corpus and table as cut there (the cell shares them), the
    mix's batch, pool and query length as the hand-made backlog copy."""
    files = _files()
    cut = tiny("c2-1k.ingest")["cfg"]
    for key in ("corpus", "table"):
        files["cfg"][key] = cut[key]
    hand = tiny(CELL)["mix"]
    files["mix"].update({k: hand[k] for k in ("batch", "pool_batches",
                                              "query_s")})
    return files


def test_match_cell_files_load_without_a_chip():
    files = _files()
    assert files["cell"]["chips"] == 1
    assert files["mix"]["kind"] == "backlog"
    assert files["mix"]["batch"] * files["mix"]["pool_batches"] == 1152
    assert files["mix"]["traced_batches"] == files["mix"]["pool_batches"]
    assert set(files["limits"]) == {
        "table_entries_gap", "table_counts_gap", "query_hashes_gap",
        "vote_rows_differing_share", "vote_counts_gap"}
    assert [m["name"] for m in files["end_to_end"]] == ["setup_s",
                                                        "match_qps"]
    assert sorted(m["name"] for m in files["per_layer"]) == sorted(
        f"{q}.match" for q in (
            "match_dispatch_ms", "match_resolve_wait_ms", "device_idle_pct",
            "graph_captures", "graph_pin_ms", "graph_launch_ms",
            "graph_capture_s"))
    for m in files["end_to_end"] + files["per_layer"]:
        assert callable(run.reader(m["name"]))


def test_batch_is_the_cli_default():
    from audfprint_torch.cli import make_parser

    assert _files()["mix"]["batch"] == make_parser().get_default("batchsize")


def test_match_qps_is_reported_by_the_match_cell_alone():
    e2e = {m["name"]: m for m in run.manifest()["end_to_end"]}
    assert e2e["match_qps"]["workloads"] == [CELL]
    assert e2e["match_qps"]["bound"] <= 0.25
    for w in run.manifest()["workloads"]:
        names = [m["name"] for m in run.cell_files(run.manifest(),
                                                   w["name"])["end_to_end"]]
        assert ("match_qps" in names) == (w["name"] == CELL)


def test_config_is_the_c2_1k_db_with_the_config3_queries():
    cfg = _files()["cfg"]
    assert cfg["query_conditions"] == CONDITIONS
    assert cfg["query_analyzer"] == {"density": 40, "shifts": 4, "fanout": 3}
    c2 = run.load_json(os.path.join(run.HERE, "configs", "c2-1k.json"))
    for key in ("corpus", "db_analyzer", "table", "matcher"):
        assert cfg[key] == c2[key], key
    assert cfg["reduced"] == []


def test_hand_made_backlog_limits_equal_the_listed_ones():
    assert BACKLOG_LIMITS == _files()["limits"]


def test_control_is_not_correct_under_the_listed_limits():
    files = _cpu_files()
    limits = files["limits"]
    r = control.readings(files, SEED, "cpu")
    assert set(r) == set(limits)
    assert any(v > limits[k] for k, v in r.items()), r


def _cpu_line():
    line = run_tiny(_cpu_files())
    assert set(line["checks"]) == set(_files()["limits"])
    return line


def test_cpu_run_of_the_listed_cell_is_correct():
    line = _cpu_line()
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"setup_s", "match_qps"}
    assert line["metrics"]["match_qps"]["value"] > 0


def test_cpu_run_with_an_altered_answer_is_not_correct(monkeypatch):
    from audfprint_torch.match.matcher import Matcher

    fn = Matcher.match_fused_resolve

    def resolve(self, analyzer, ht, handle):
        res, nh = fn(self, analyzer, ht, handle)
        res = [r.copy() for r in res]
        hit = next((i for i, r in enumerate(res) if len(r)), None)
        if hit is not None:                   # every resolved batch's
            res[hit][0, 2] += 3               # first match: its offset
        return res, nh

    monkeypatch.setattr(Matcher, "match_fused_resolve", resolve)
    line = _cpu_line()
    assert not line["correct"], line["checks"]
    assert line["checks"]["vote_rows_differing_share"]["value"] > \
        line["checks"]["vote_rows_differing_share"]["limit"]
