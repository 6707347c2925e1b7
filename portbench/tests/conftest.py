"""CPU tests of the benchmark harness (python -m pytest portbench/tests).

`tiny(workload)` loads a cell's files as the run does and cuts its sizes
so that the whole run, the comparison with the reference included, takes
seconds on the CPU with the program's plain (non-CUDA) paths."""

import os
import tempfile
import time

import pytest

from portbench import run

SEED = 3_000_000_019          # above 2**31: seeds may pass 32 bits


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped without one")
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers > 1:
        # a worker's share of the cores: torch's OpenMP threads spin while
        # they wait, and oversubscribed they stall every worker
        import torch
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))


# The backlog kind of traffic has no cell in BENCHMARK.json yet (PERF.md
# says why); its tests run it on the c2-1k configuration, with the clean
# queries of c2-1k.match or the config-3 queries of c3-noisy.match (the
# repository's CONFIG3_CONDITIONS, held equal by test_pb_traffic.py).
CONDITIONS = [{}, {"snr_db": 10}, {"snr_db": 5}, {"snr_db": 0},
              {"lowpass_hz": 3000}, {"speed": 1.02}, {"speed": 0.97},
              {"speed": 1.04},
              {"snr_db": 5, "lowpass_hz": 3000, "speed": 1.02}]
BACKLOG = {
    "c2-1k.match": ({}, 3.0),
    "c3-noisy.match": ({"query_analyzer": {"density": 40, "shifts": 4,
                                           "fanout": 3},
                        "query_conditions": CONDITIONS}, 2.0)}
BACKLOG_LIMITS = {"table_entries_gap": 0.15, "table_counts_gap": 0.005,
                  "query_hashes_gap": 0.07, "vote_rows_differing_share": 0.01,
                  "vote_counts_gap": 0.4}


def tiny(workload: str) -> dict:
    bench = run.manifest()
    if workload in BACKLOG:
        over, query_s = BACKLOG[workload]
        files = {"cell": {"name": workload, "config": "c2-1k", "chips": 1},
                 "cfg": run.load_json(os.path.join(run.HERE, "configs",
                                                   "c2-1k.json")),
                 "mix": {"kind": "backlog", "batch": 4, "pool_batches": 3,
                         "query_s": query_s},
                 "limits": dict(BACKLOG_LIMITS),
                 "end_to_end": [{"name": "setup_s", "unit": "s"},
                                {"name": "match_qps", "unit": "queries/s"}],
                 "per_layer": []}
        files["cfg"].update(over)
    else:
        files = run.cell_files(bench, workload)
    files["cfg"]["corpus"].update(tracks=24, track_s=6.0)
    files["cfg"]["table"]["hashbits"] = 16
    if files["mix"]["kind"] == "ingest":
        files["mix"].update(tracks=20, chunk=8)
    return files


def run_tiny(files: dict, seconds: float = 1.5, seed: int = SEED) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        return run.run_cell(files, seed, seconds, False, "cpu", tmp,
                            time.time())


@pytest.fixture
def repo_root():
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
