"""The stream kind (portbench/kinds/stream.py) at a small size on the CPU:
two 20 s recordings, each streamed (above_s 1 s) in 64-frame chunks into a
2^16 x 100 table at maxtime 2^19, one file a chunk.  The sound run comes
out correct; a fault of the timed path comes out as not correct: a store
that leaves the table unchanged, half of one file's hashes left out, one
hash altered where cli._stream_chunk returns it; so does the control, the
reference in bfloat16 in the program's place."""

import pytest

from portbench import control, run
from portbench.tests.conftest import SEED, run_tiny


def _tiny() -> dict:
    files = run.cell_files(run.manifest(), "long.stream")
    files["cfg"]["corpus"]["track_s"] = 20.0
    files["cfg"]["stream"].update(above_s=1.0, chunk_frames=64)
    files["cfg"]["table"]["hashbits"] = 16
    files["mix"].update(files=2, batch=1)
    return files


def test_sound_run_is_correct():
    line = run_tiny(_tiny())
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 2 and line["failed"] == 0


def _broken(monkeypatch, where, wrap) -> dict:
    monkeypatch.setattr(where[0], where[1], wrap(getattr(*where)))
    line = run_tiny(_tiny())
    assert not line["correct"], line["checks"]
    return line


def test_store_that_leaves_the_table_unchanged(monkeypatch):
    from audfprint_torch.models import ingest as ING

    def wrap(fn):
        def step(times, hashes, valid, ids, table, counts, tcfg):
            t0, c0 = table.clone(), counts.clone()
            fn(times, hashes, valid, ids, table, counts, tcfg)
            table.copy_(t0)
            counts.copy_(c0)
        return step
    line = _broken(monkeypatch, (ING, "_store_step"), wrap)
    assert line["checks"]["table_entries_gap"]["value"] >= 1.0


def _first_file(change):
    """A wrap of cli._stream_chunk that changes the first recording's
    hashes, (n, 2) int32 (t, hash) rows, where they are returned."""
    def wrap(fn):
        def stream_chunk(analyzer, report, ordered):
            out = fn(analyzer, report, ordered)
            name, kind, (h, dur) = out[0]
            if name.endswith("rec0.wav"):
                out[0] = (name, kind, (change(h.copy()), dur))
            return out
        return stream_chunk
    return wrap


def test_half_of_one_files_hashes_left_out(monkeypatch):
    from audfprint_torch import cli
    line = _broken(monkeypatch, (cli, "_stream_chunk"),
                   _first_file(lambda h: h[: len(h) // 2]))
    assert line["checks"]["track_hashes_gap"]["value"] >= 0.4


def test_one_hash_altered(monkeypatch):
    from audfprint_torch import cli

    def alter(h):
        h[len(h) // 2, 1] ^= 1 << 7          # one bit of one hash
        return h
    _broken(monkeypatch, (cli, "_stream_chunk"), _first_file(alter))


@pytest.mark.parametrize("seed", [SEED, SEED + 1])
def test_control_fails_every_number(seed):
    files = _tiny()
    r = control.readings(files, seed, "cpu")
    assert set(r) == set(files["limits"])
    assert all(v > files["limits"][k] for k, v in r.items()), r


SPANS = {"stream_bwd_prune_ms.stream": "stream.bwd_prune",
         "stream_fetch_ms.stream": "stream.fetch",
         "stream_read_ms.stream": "stream.read",
         "stream_pair_ms.stream": "stream.pair"}


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_span_readers(metric, monkeypatch):
    """A stream span's reader is its mean ms a call (6 ms over 3 calls);
    None from a tracer that never saw the span, as the program before
    these spans gives."""
    from audfprint_torch.utils import timing
    tr = timing.Tracer()
    monkeypatch.setattr(timing, "TRACER", tr)
    assert run.reader(metric)({}) is None
    tr.total_ns[SPANS[metric]] = 6_000_000
    tr.calls[SPANS[metric]] = 3
    assert run.reader(metric)({}) == 2.0


def test_k1f_roofline():
    """K1f's bytes: the smoke run's k1f_bound at a full chunk, a file cut
    into the route's chunks, and the share over the K1f kernels' time."""
    from audfprint_torch.ops.config import PipelineConfig
    from portbench import roofline_k1f
    B, T, F, k = 1, 8192, 256, 5
    full = 4 * (B * T * F + 2 * B * F + 2 * F - 1 + 2 * B * T * k)
    assert roofline_k1f.k1f_bytes([T]) == full
    cfg = PipelineConfig()
    n = 512 + 256 * (2 * T + 99)              # 2 T + 100 frames
    assert roofline_k1f.file_bytes(n, cfg, T) == (
        2 * full + roofline_k1f.k1f_bytes([100]))
    rec = {"k1f_bytes": full,
           "trace": {"kernel_s": {"prune_fwd_carry_kernel": full / 3.35e12,
                                  "prune_fwd_bwd_kernel": 1.0}}}
    assert run.reader("k1f_roofline_pct.stream")(rec) == pytest.approx(100.0)
    assert run.reader("k1f_roofline_pct.stream")({}) is None


def test_run_finds_the_cell(monkeypatch, capsys):
    """python -m portbench --workload long.stream finds the listed cell's
    files and gets as far as the chip check."""
    asked = []
    monkeypatch.setattr(run, "check_chip",
                        lambda chips: asked.append(chips) or "no card")
    argv = ["--workload", "long.stream", "--seed", "5", "--seconds", "1"]
    assert run.main(argv) == 2
    assert asked == [1] and capsys.readouterr().out == ""
