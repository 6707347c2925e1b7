"""The long.stream cell in BENCHMARK.json: its entries meet the manifest's
contract, its files load without a chip, a reader is found for each of its
metrics, and the stream kind is among the kinds an unknown one names."""

import pytest

from portbench import run
from portbench.tests import test_pb_manifest as contract

CELL = "long.stream"


@pytest.mark.parametrize("check", [
    "test_names_units_and_text", "test_entry_keys",
    "test_every_cell_resolves_its_files",
    "test_per_layer_metrics_name_their_cells_and_one_mover"])
def test_listed_long_stream_meets_the_manifest_contract(check):
    assert CELL in [w["name"] for w in run.manifest()["workloads"]]
    getattr(contract, check)()


def test_long_stream_files_load_without_a_chip():
    files = run.cell_files(run.manifest(), CELL)
    assert files["mix"]["kind"] == "stream"
    assert files["cfg"]["table"]["maxtimebits"] == 19
    assert set(files["limits"]) == {"table_entries_gap", "table_counts_gap",
                                    "track_hashes_gap"}
    assert [m["name"] for m in files["end_to_end"]] == [
        "setup_s", "ingest_audio_s_per_s"]
    assert len(files["per_layer"]) == 13
    for m in files["per_layer"]:
        assert callable(run.reader(m["name"]))


def test_unknown_kind_names_the_stream_kind():
    with pytest.raises(SystemExit) as e:
        run.kind("nope")
    assert all(f"'{k}'" in str(e.value)
               for k in ("backlog", "ingest", "stream"))
