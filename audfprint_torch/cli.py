"""Command-line interface (port of audfprint_tpu/cli.py).

Same commands (new | add | precompute | merge | newmerge | match | list |
remove | warmup), same flags and defaults, same output lines.  Ingest and
match run batched on one device with the host HashTable store and the host
merge; `--device-store` keeps the table on the device during new/add
(models/ingest.py), and WAVs longer than `--stream-above` seconds are
analysed in chunks of `--stream-chunk` frames (models/streaming.py).
`--ndev N` shards the table by bucket range over N shards, placed round-
robin on the local devices (several on one card when it has fewer): new /
add route every hash to its shard (the device store), match votes after a
hit exchange, merge / newmerge replay the sources into the sharded table;
all give the --ndev 1 results bit for bit.  Unset, --ndev is the number of
local devices: the single-device paths on one card.
`match` also serves `--windowed` (broadcast monitoring), `--speed-sweep`,
`--listen` (a stdin serving loop) and the `-I`/`-J`/`--sonify`
diagnostics; `--profile DIR` writes a torch.profiler trace, the
program's spans (utils/timing) among its ranges; `--idbits`
past 32 - maxtimebits makes a wide table.

The device is a keyword of `main` (CUDA by default), so tests can drive
the CLI on the CPU: `main(argv, device="cpu")`.
"""

from __future__ import annotations

import argparse
import os
import queue
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from audfprint_torch import params as P
from audfprint_torch.index.hash_table import HashTable
from audfprint_torch.utils import audio as audio_io
from audfprint_torch.utils import formats
from audfprint_torch.utils import timing
from audfprint_torch.utils.timing import Stages
from audfprint_torch.match.matcher import Matcher, slice_hash_windows
from audfprint_torch.models.analyzer import Analyzer
from audfprint_torch.models.ingest import DeviceIngest
from audfprint_torch.ops import pipeline as pipe
from audfprint_torch.utils import graphs
from audfprint_torch.utils.device import resolve_device

COMMANDS = ("new", "add", "precompute", "merge", "newmerge", "match",
            "list", "remove", "warmup")


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="audfprint_torch", add_help=False,
        description="PyTorch/CUDA landmark audio fingerprinter "
                    "(capabilities of dpwe/audfprint)")
    p.add_argument("command", choices=COMMANDS)
    p.add_argument("file", nargs="*")
    p.add_argument("--help", action="help")
    a = p.add_argument
    a("-n", "--density", type=float, default=P.DENSITY)
    a("-h", "--hashbits", type=int, default=P.TABLE_HASHBITS)
    a("-b", "--bucketsize", type=int, default=P.TABLE_DEPTH)
    a("-t", "--maxtime", type=int, default=P.TABLE_MAXTIME)
    a("-u", "--maxtimebits", type=int, default=None)
    a("-r", "--samplerate", type=int, default=P.TARGET_SR)
    a("-d", "--dbase", type=str, default=None)
    a("-o", "--opfile", type=str, default=None)
    a("-F", "--fanout", type=int, default=P.MAX_PAIRS_PER_PEAK)
    a("-P", "--pks-per-frame", dest="pks_per_frame", type=int,
      default=P.MAX_PKS_PER_FRAME)
    a("-i", "--shifts", type=int, default=0)
    a("-S", "--freq-sd", dest="freq_sd", type=float, default=P.F_SD)
    a("-D", "--search-depth", dest="search_depth", type=int,
      default=P.SEARCH_DEPTH)
    a("-w", "--match-win", dest="match_win", type=int, default=P.MATCH_WIN)
    a("-N", "--min-count", dest="min_count", type=int, default=P.MIN_COUNT)
    a("-x", "--max-matches", dest="max_matches", type=int,
      default=P.MAX_MATCHES)
    a("-X", "--exact-count", dest="exact_count", action="store_true")
    a("-R", "--find-time-range", dest="find_time_range", action="store_true")
    a("-Q", "--time-quantile", dest="time_quantile", type=float,
      default=P.TIME_QUANTILE)
    a("-T", "--sortbytime", action="store_true")
    a("-H", "--ncores", type=int, default=None,
      help="host decode threads (default: auto = 2; 1 = serial)")
    a("-K", "--precompute-peaks", dest="precompute_peaks",
      action="store_true")
    a("-k", "--skip-existing", dest="skip_existing", action="store_true")
    a("-C", "--continue-on-error", dest="continue_on_error",
      action="store_true")
    a("-l", "--list", dest="listflag", action="store_true")
    a("-W", "--wavdir", type=str, default="")
    a("-V", "--wavext", type=str, default="")
    a("-p", "--precompdir", type=str, default=".")
    a("-I", "--illustrate", action="store_true")
    a("-J", "--illustrate-hpf", dest="illustrate_hpf", action="store_true")
    a("--sonify", action="store_true")
    a("-v", "--verbose", type=int, default=1)
    a("--batchsize", type=int, default=16,
      help="files analyzed per device batch")
    a("--ndev", type=int, default=None,
      help="table shards for store/match/merge, placed round-robin on the "
           "local devices (default: one per device; 1 = single-device "
           "paths; results are identical at any value)")
    a("--idbits", type=int, default=0,
      help="track-id bits of the entry packing (0 = the reference's "
           "32 - maxtimebits). idbits + maxtimebits > 32 switches to "
           "wide 64-bit entries: capacity beyond the reference's 2^18 "
           "tracks / mod-16384 time cap")
    a("--device-store", dest="device_store", action="store_true",
      help="new/add: keep the hash table on the device and fingerprint + "
           "store each chunk in one pass; the saved database equals the "
           "host store's")
    a("--speed-sweep", dest="speed_sweep", type=float, default=0.0,
      help="match: also fingerprint each query at speed corrections up "
           "to +/-PCT%% (1%% steps, extra device batch rows) and report "
           "the best-scoring variant. Recovers speed-changed queries "
           "that landmark dt/df quantization inherently misses "
           "(capability beyond the reference; default off keeps output "
           "bit-identical)")
    a("--windowed", type=float, default=0.0, metavar="SEC",
      help="match: broadcast-monitoring mode - slice each (long) query "
           "into SEC-second windows (hash-domain slicing after ONE "
           "fingerprint pass; all windows matched as one device batch) "
           "and report each window's matches as '<query> t=<start>s'. "
           "Finds every DB track occurring anywhere inside a long "
           "recording (capability beyond the reference)")
    a("--window-hop", dest="window_hop", type=float, default=0.0,
      metavar="SEC", help="match --windowed: window hop in seconds "
                          "(default SEC/2, 50%% overlap)")
    a("--warm-durations", dest="warm_durations", type=str, default="5,10",
      help="warmup: comma-separated query durations (seconds) whose "
           "fingerprint + match paths to run once")
    a("--listen", action="store_true",
      help="match: serving loop - read query paths from stdin (one per "
           "line), match against the cached device table, and emit "
           "result lines immediately (flushed), in input order. Pending "
           "lines are drained and served as ONE device batch (up to "
           "--batchsize): interactive callers keep single-query latency, "
           "backlogged pipes get batched-match throughput. EOF ends; "
           "blank lines are ignored (capability beyond the reference)")
    a("--stream-above", dest="stream_above", type=float, default=3600.0,
      metavar="SEC",
      help="WAV inputs longer than SEC analyse in fixed-size chunks with "
           "O(chunk) host and device memory (carried HPF and envelope "
           "state, exact sparse backward prune); 0 disables streaming")
    a("--stream-chunk", dest="stream_chunk", type=int, default=8192,
      metavar="FRAMES",
      help="streamed ingest chunk size in analysis frames (~190 s at the "
           "defaults); results are identical at any value")
    a("--profile", type=str, default=None,
      help="write a torch.profiler Chrome trace (host and CUDA activity, "
           "with the program's spans as ranges: ingest.*, graph.*, "
           "stage.*) to this directory")
    a("--json-metrics", dest="json_metrics", type=str, default=None,
      help="write per-stage timing/counters JSON to this file, with the "
           "program's spans (total and self seconds, calls), counters, "
           "graph capture seconds and span records")
    return p


def setup_analyzer(args, device) -> Analyzer:
    an = Analyzer(density=args.density,
                  target_sr=args.samplerate,
                  shifts=max(1, args.shifts),
                  maxpksperframe=args.pks_per_frame,
                  maxpairsperpeak=args.fanout,
                  f_sd=args.freq_sd,
                  fail_on_error=not args.continue_on_error,
                  device=device)
    an.stream_above_sec = max(0.0, args.stream_above)
    an.stream_chunk_frames = max(64, args.stream_chunk)
    return an


def setup_matcher(args, device) -> Matcher:
    return Matcher(window=args.match_win,
                   threshcount=args.min_count,
                   max_returns=args.max_matches,
                   search_depth=args.search_depth,
                   exact_count=args.exact_count,
                   find_time_range=args.find_time_range,
                   time_quantile=args.time_quantile,
                   sort_by_time=args.sortbytime,
                   verbose=args.verbose,
                   illustrate=args.illustrate,
                   illustrate_hpf=args.illustrate_hpf,
                   sonify=args.sonify,
                   # unset --ndev = auto: one shard per local device
                   ndev=args.ndev if args.ndev is not None else 0,
                   device=device)


def filename_list_iterator(filelist, wavdir: str, wavext: str,
                           listflag: bool):
    """Expand CLI file args: --list makes each arg a file of filenames;
    --wavdir/--wavext prefix and suffix each name."""
    if not listflag:
        for name in filelist:
            yield os.path.join(wavdir, name + wavext)
    else:
        for listfile in filelist:
            with open(listfile) as f:
                for line in f:
                    name = line.rstrip("\n")
                    if name:
                        yield os.path.join(wavdir, name + wavext)


def _new_table(args) -> HashTable:
    maxtime = ((1 << args.maxtimebits) if args.maxtimebits is not None
               else args.maxtime)
    return HashTable(hashbits=args.hashbits, depth=args.bucketsize,
                     maxtime=maxtime, idbits=args.idbits)


def _check_params(ht: HashTable, analyzer: Analyzer, report) -> None:
    """DB/analyzer param compat check (the DB stores analyzer params)."""
    want = analyzer.params_dict()
    for k, v in (ht.params or {}).items():
        if k in want and want[k] != v:
            report(f"Warning: database {k}={v} but analyzer {k}={want[k]}")


def _decode_threads(ncores) -> int:
    return 2 if ncores is None else max(1, ncores)


def _decode_many(analyzer: Analyzer, names: list, ncores, report):
    """Host-parallel decode.  16-bit mono WAVs at the analysis rate stay
    raw int16; other PCM WAVs take the native threaded loader when it is
    available; everything else decodes per file."""
    results: dict[int, object] = {}
    wav_idx = [i for i, n in enumerate(names)
               if n.lower().endswith(".wav") and os.path.exists(n)
               and not audio_io.wav_is_target_mono16(n, analyzer.target_sr)]
    if wav_idx:
        fast = audio_io.read_wav_batch([names[i] for i in wav_idx],
                                       sr=analyzer.target_sr,
                                       n_threads=_decode_threads(ncores))
        if fast is not None:
            for i, d in zip(wav_idx, fast):
                if d is not None:
                    results[i] = d
    todo = [i for i in range(len(names)) if i not in results]

    def _one(name):
        try:
            d, _ = audio_io.audio_read_staged(name, sr=analyzer.target_sr)
            return d
        except audio_io.DecodeError as e:
            if analyzer.fail_on_error:
                raise
            report(f"Error reading {name}: {e}")
            return None

    if todo:
        nthreads = _decode_threads(ncores) if len(todo) > 1 else 1
        if nthreads > 1:
            with ThreadPoolExecutor(max_workers=nthreads) as ex:
                slow = list(ex.map(_one, [names[i] for i in todo]))
        else:
            slow = [_one(names[i]) for i in todo]
        for i, d in zip(todo, slow):
            results[i] = d
    return [results[i] for i in range(len(names))]


def _ingest_device_store(ht: HashTable, args, report, analyzer):
    """The fused device ingest for new/add (models/ingest.DeviceIngest):
    sharded, with every hash routed to its shard, when --ndev resolves to
    more than 1, on one device when --device-store is set.  None (the host
    store and a two-stage fingerprint) on one device without
    --device-store, or for a table the shards do not divide."""
    from audfprint_torch.parallel import sharded
    ndev = sharded.resolve_ndev(args.ndev, analyzer.device)
    if ndev <= 1 and not getattr(args, "device_store", False):
        return None
    try:
        return DeviceIngest(ht, analyzer, max(1, ndev))
    except ValueError as e:
        report(f"Note: {e}; using host store")
        return None


def do_merge(ht: HashTable, names: list, args, report, stages: Stages,
             device=None) -> None:
    """CLI merge/newmerge.

    With --ndev > 1 the merge runs as resharding on the mesh: one table
    upload, every source's entry stream replayed through the sharded
    deterministic reservoir, one download.  Bit-identical to the chained
    host merge: the replay continues from the true-pressure counts, synced
    again from the host after every source, so a source's own bucket
    overflow never skews the next source's slot decisions (the rule
    HashTable.merge applies).  One device, or a table the shards do not
    divide, takes the vectorised host merge."""
    from audfprint_torch.parallel import sharded
    device = resolve_device(device)
    ndev = sharded.resolve_ndev(args.ndev, device)
    mesh = None
    if ndev > 1 and names:
        try:
            mesh = sharded.make_mesh(ndev, sharded.mesh_devices(device))
            with stages.time("upload"):
                table, counts, tcfg = sharded.upload_sharded(ht, mesh)
            merge_fn = sharded.sharded_merge_fn(mesh, tcfg)
        except ValueError as e:
            report(f"Note: {e}; using host merge")
            mesh = None
    if mesh is None:
        for name in names:
            other = HashTable(name)
            with stages.time("merge"):
                ht.merge(other)
            report(f"merged {name} "
                   f"({sum(1 for n in other.names if n)} files)")
        return
    for name in names:
        other = HashTable(name)
        idoffset = ht._merge_meta(other)
        hs, es, vs = sharded.entry_streams(other, id_offset=idoffset)
        if len(hs):
            with stages.time("merge"):
                merge_fn(table, counts, hs, es, vs)
        ht._merge_counts(other)
        # the true combined pressure, before the next source
        counts = sharded.shard_rows(
            mesh, np.ascontiguousarray(ht.counts, np.int32))
        report(f"merged {name} ({sum(1 for n in other.names if n)} files)")
    with stages.time("download"):
        ht.table = sharded.gather_sharded(mesh, table).view(ht.table.dtype)


def _decode_chunk(analyzer: Analyzer, args, report, chunk: list) -> list:
    """Decode one chunk on the host -> (name, kind, payload) entries in
    input order.  kind is "pre" (precomputed, loads later), "wav"
    (payload = decoded samples) or "stream" (a WAV past --stream-above,
    payload None until _stream_chunk analyses it)."""
    def _kind(n):
        if os.path.splitext(n)[1] in (formats.PRECOMPEXT,
                                      formats.PRECOMPPKEXT):
            return "pre"
        return "stream" if analyzer._should_stream(n) else "wav"

    kinds = [_kind(n) for n in chunk]
    wavs = [n for n, k in zip(chunk, kinds) if k == "wav"]
    signals = iter(_decode_many(analyzer, wavs, args.ncores, report))
    return [(n, k, next(signals) if k == "wav" else None)
            for n, k in zip(chunk, kinds)]


def _stream_chunk(analyzer: Analyzer, report, ordered: list) -> list:
    """The "stream" entries of a decoded chunk analysed chunk-wise as one
    group (Analyzer.wavfiles2hashes_streaming), with O(chunk) memory:
    payload = (hashes, duration), or None when reading failed (reported).
    The streamed route runs on the device, so it runs on the thread that
    dispatches: a CUDA graph captured there in the default global mode
    must see no CUDA call from another thread."""
    names = [n for n, k, _d in ordered if k == "stream"]
    got = iter(analyzer.wavfiles2hashes_streaming(names) if names else ())
    out = []
    for n, k, d in ordered:
        if k == "stream":
            d = next(got)
            if isinstance(d, Exception):
                if analyzer.fail_on_error:
                    raise d
                report(f"Error reading {n}: {d}")
                d = None
        out.append((n, k, d))
    return out


def _resolve_chunk(analyzer: Analyzer, ordered: list, hashes_iter,
                   report) -> list:
    """Decoded entries + resolved hashes -> ordered (name, hashes, dur)
    rows; precomputed files load here; failures are reported + skipped."""
    rows = []
    for name, kind, d in ordered:
        if kind == "wav":
            if d is None:
                continue                       # decode failed, reported
            rows.append((name, next(hashes_iter),
                         len(d) / analyzer.target_sr))
            continue
        if kind == "stream":
            if d is not None:                  # else: failed, reported
                rows.append((name, d[0], d[1]))
            continue
        try:
            h = analyzer.wavfile2hashes(name)  # .afpt or .afpk
        except (OSError, ValueError) as e:
            if analyzer.fail_on_error:
                raise
            report(f"Error reading {name}: {e}")
            continue
        rows.append((name, h, analyzer.soundfiledur))
    return rows


def _run_pipelined(chunks: list, analyzer: Analyzer, args, report,
                   stages: Stages, consume, dispatch) -> None:
    """Decode chunk i+1 on a host thread while the device works on chunk i
    and `consume(ordered, handle)` handles chunk i-1.  The decode thread
    touches no CUDA: chunk i's streamed files are analysed here, just
    before its dispatch."""
    pool = ThreadPoolExecutor(max_workers=1)

    def dec(c):
        return _decode_chunk(analyzer, args, report, c)

    pending = pool.submit(dec, chunks[0]) if chunks else None
    in_flight = None
    try:
        for ci in range(len(chunks)):
            with stages.time("decode"):
                ordered = pending.result()
            pending = (pool.submit(dec, chunks[ci + 1])
                       if ci + 1 < len(chunks) else None)
            with stages.time("decode"):
                ordered = _stream_chunk(analyzer, report, ordered)
            with stages.time("dispatch"):
                handle = dispatch(ordered)
            if in_flight is not None:
                consume(*in_flight)
            in_flight = (ordered, handle)
        if in_flight is not None:
            consume(*in_flight)
    finally:
        # the decode worker may still call report(); wait for it
        pool.shutdown(wait=True)


def _wav_signals(ordered: list) -> list:
    return [d for _, kind, d in ordered if kind == "wav" and d is not None]


def do_ingest(ht: HashTable, analyzer: Analyzer, names: list, args,
              report, stages: Stages) -> tuple[int, float]:
    """Batched analyze + store; returns (n_files, total_dur).

    With a device store (--ndev > 1, or --device-store on one device) each
    chunk is one fused fingerprint + store pass on the device and one small
    counts fetch (models/ingest.DeviceIngest; the hashes never reach the
    host); otherwise the fingerprints come to the host and go into the host
    table."""
    tot_dur = 0.0
    n_done = 0
    store = _ingest_device_store(ht, args, report, analyzer)
    if args.skip_existing:
        present = {n for n in ht.names if n is not None}
        for n in names:
            if n in present:
                report(f"skipping existing {n}")
        names = [n for n in names if n not in present]
    B = max(1, args.batchsize)
    chunks = [names[i: i + B] for i in range(0, len(names), B)]

    def consume(ordered, handle):
        nonlocal tot_dur, n_done
        if store is not None:
            # stored at dispatch, in input order; report only after the
            # counts fetch, so a failed store leaves no "ingested" line
            with stages.time("analyze"):
                rows = store.consume_chunk(handle)
        else:
            with stages.time("analyze"):
                hashes = iter(analyzer.fingerprint_resolve(handle))
            rows = []
            for name, h, dur in _resolve_chunk(analyzer, ordered, hashes,
                                               report):
                with stages.time("store"):
                    ht.store_vectorized(name, h)
                rows.append((name, len(h), dur))
        for name, nh, dur in rows:
            tot_dur += dur
            n_done += 1
            report(f"ingested #{n_done}: {name} ({dur:.1f} s, {nh} hashes)")

    if store is not None:
        def dispatch(ordered):
            return store.dispatch_chunk(ordered, report)
    else:
        def dispatch(ordered):
            return analyzer.fingerprint_async(_wav_signals(ordered))
    try:
        _run_pipelined(chunks, analyzer, args, report, stages, consume,
                       dispatch)
    finally:
        # even when a chunk raises (fail_on_error), the host table must
        # hold every chunk already stored on the device: names and
        # hashesperid were updated eagerly
        if store is not None:
            with stages.time("store"):
                store.finalize()
    return n_done, tot_dur


def _precomp_outname(name: str, args, ext: str) -> str:
    outname = os.path.splitext(name)[0] + ext
    if args.precompdir not in ("", "."):
        outname = os.path.join(args.precompdir,
                               os.path.normpath(outname).lstrip(os.sep))
    return outname


def do_precompute(analyzer: Analyzer, names: list, args,
                  report) -> tuple[int, float]:
    """Batched precompute: files fingerprinted (or peak-picked, -K) in
    device batches, one .afpt (.afpk) written per input."""
    tot_dur = 0.0
    n_done = 0
    ext = formats.PRECOMPPKEXT if args.precompute_peaks else formats.PRECOMPEXT
    todo = []
    for name in names:
        outname = _precomp_outname(name, args, ext)
        if args.skip_existing and os.path.exists(outname):
            report(f"skipping existing {outname}")
            continue
        todo.append((name, outname))
    B = max(1, args.batchsize)
    for i in range(0, len(todo), B):
        chunk = todo[i: i + B]
        signals = _decode_many(analyzer, [n for n, _ in chunk],
                               args.ncores, report)
        good = [(n, o, d) for (n, o), d in zip(chunk, signals)
                if d is not None]
        if not good:
            continue
        if args.precompute_peaks:
            results = analyzer.samples_batch2peaks([d for _, _, d in good])
            save, unit = formats.peaks_save, "peaks"
        else:
            results = analyzer.samples_batch2hashes([d for _, _, d in good])
            save, unit = formats.hashes_save, "hashes"
        for (name, outname, d), r in zip(good, results):
            os.makedirs(os.path.dirname(outname) or ".", exist_ok=True)
            save(outname, r)
            dur = len(d) / analyzer.target_sr
            tot_dur += dur
            n_done += 1
            report(f"wrote {outname} ( {len(r)} {unit}, {dur:.1f} sec)")
    return n_done, tot_dur


def do_match(ht: HashTable, analyzer: Analyzer, matcher: Matcher,
             names: list, args, report,
             stages: Stages) -> tuple[int, float]:
    """Batched query matching with decode/compute overlap; output lines
    follow the input order.  Plain chunks of decoded audio take the fused
    fingerprint+match path; the others (precomputed inputs, past the
    memory budget, --windowed, --speed-sweep) fingerprint, then match the
    hashes: windows of every file in the chunk as one batch, or each
    query with its speed variants (base hashes only without a sweep)."""
    tot_dur = 0.0
    n_done = 0
    B = max(1, args.batchsize)
    chunks = [names[i: i + B] for i in range(0, len(names), B)]
    pct = args.speed_sweep
    wsec, whop = args.windowed, args.window_hop
    fps = analyzer.target_sr / float(analyzer.n_hop)
    # windows need the hashes, speed variants the samples, on the host
    fused_ok = wsec <= 0 and not pct

    def emit(label, rrows, dur, nh, suffix=""):
        msgs = matcher.results_to_msgs(rrows, dur, nh, analyzer, ht, label)
        if suffix:
            msgs[0] += suffix
        for msg in msgs:
            report(msg)

    def dispatch(ordered):
        sigs = _wav_signals(ordered)
        if fused_ok and sigs and len(sigs) == len(ordered):
            h = matcher.match_samples_fused_async(analyzer, ht, sigs)
            if h is not None:
                return ("fused", h)
        return ("fp", analyzer.fingerprint_async(sigs))

    def consume(ordered, handle):
        nonlocal tot_dur, n_done
        tag, payload = handle
        if tag == "fused":
            with stages.time("match"):
                res, nh = matcher.match_fused_resolve(analyzer, ht, payload)
            for (name, _k, d), rrows, n in zip(ordered, res, nh):
                dur = len(d) / analyzer.target_sr
                emit(name, rrows, dur, n)
                tot_dur += dur
                n_done += 1
            return
        with stages.time("analyze"):
            hashes = iter(analyzer.fingerprint_resolve(payload))
        rows = _resolve_chunk(analyzer, ordered, hashes, report)
        if not rows:
            return
        if wsec > 0:
            # the summary counts files, not windows
            n_done += len(rows)
            tot_dur += sum(dur for _, _, dur in rows)
            wrows = [(f"{name} t={t0:.1f}s", sel, wdur)
                     for name, h, dur in rows
                     for t0, sel, wdur in slice_hash_windows(h, dur, wsec,
                                                             fps, whop)]
            with stages.time("match"):
                wres = matcher.match_hashes_batch(
                    ht, [h for _, h, _ in wrows])
            for (label, h, wdur), rrows in zip(wrows, wres):
                emit(label, rrows, wdur, len(h))
            return
        # precomputed rows have no samples: their base hashes only
        smp = {n: d for n, kind, d in ordered
               if kind == "wav" and d is not None}
        with stages.time("match"):
            best = matcher.match_samples_sweep(
                analyzer, ht, [smp.get(n) for n, _, _ in rows], pct,
                base_hashes=[h for _, h, _ in rows])
        for (name, _h, dur), (rrows, f, nh) in zip(rows, best):
            emit(name, rrows, dur, nh,
                 f" (speed {round((f - 1) * 100):+d}%)"
                 if f != 1.0 and len(rrows) else "")
            tot_dur += dur
            n_done += 1

    _run_pipelined(chunks, analyzer, args, report, stages, consume, dispatch)
    return n_done, tot_dur


def warm_serving(ht: HashTable, analyzer: Analyzer, matcher: Matcher,
                 args, report) -> int:
    """The serving keys of `warmup` and `match --listen`, run once each:
    for every --warm-durations bucket, the two-stage fingerprint of
    --batchsize's power of two float32 clips, and at sub-batch sizes 1
    and that power of two the two-stage vote of their hashes and the
    fused fingerprint + match of float32 clips and of int16 PCM (what a
    16-bit WAV at the analysis rate decodes to).  On a CUDA device each
    of these calls captures the CUDA graph of its key (the Analyzer's
    fingerprint, the Matcher's vote and fused function), so the
    process's later calls of those keys replay them (a fused row flagged
    for a re-match adds its re-match's two-stage keys); cuFFT plans, the
    kernel library and the table upload are set up too.

    Returns the count the JAX package reports: one fingerprint batch per
    duration plus one or two match paths per batch size (the fused one
    only where it is eligible)."""
    rng = np.random.default_rng(0)
    sr = analyzer.target_sr
    durs = [float(x) for x in args.warm_durations.split(",") if x.strip()]
    bmax = P.next_pow2(max(1, args.batchsize))
    bsizes = sorted({1, bmax})
    n_graphs = 0
    for d in durs:
        n = max(1, int(d * sr))
        clips = [0.1 * rng.standard_normal(n).astype(np.float32)
                 for _ in range(bmax)]
        pcm = [np.clip(np.round(c * 32768.0), -32768, 32767).astype(np.int16)
               for c in clips]
        hashes = analyzer.samples_batch2hashes(clips)
        for b in bsizes:
            matcher.match_hashes_batch(ht, hashes[:b])
            fused = matcher.match_samples_fused(analyzer, ht, clips[:b])
            if fused is not None:
                matcher.match_samples_fused(analyzer, ht, pcm[:b])
            n_graphs += 2 if fused is not None else 1
        report(f"warmed {d:g} s bucket (batch sizes {bsizes})")
    return len(durs) + n_graphs


def do_warmup(ht: HashTable, analyzer: Analyzer, matcher: Matcher,
              args, report) -> int:
    """`warmup -d db`: get a serving host ready before its first query.
    Builds the kernel library into build/audfprint_torch/ if it is missing
    (a later process loads it instead of running nvcc), uploads the table,
    and runs warm_serving: the shapes a `match` / `match --listen` process
    uses, captured as CUDA graphs on a CUDA device.  Those graphs live in
    this process and die with it: CUDA graphs cannot be kept across
    processes as the JAX package's persistent compile cache keeps its
    executables, so `match --listen` captures the same keys itself before
    it reads its first line.  Returns warm_serving's count."""
    if analyzer.device.type == "cuda":
        from audfprint_torch.ops import _build
        _build.load()
    return warm_serving(ht, analyzer, matcher, args, report)


def do_listen(ht: HashTable, analyzer: Analyzer, matcher: Matcher,
              args, report, stages: Stages, out_f,
              stream=None) -> tuple[int, float]:
    """`match --listen`: a serving loop over query paths, one per line of
    `stream` (stdin by default).  Each group goes through do_match against
    the device table (uploaded once, cached by Matcher._device_state), and
    its result lines are flushed in input order.  Blank lines are skipped;
    EOF ends the loop.

    A reader thread feeds a queue; each iteration drains the lines already
    waiting (up to --batchsize) and serves them as one batch, never
    waiting for more, so an interactive caller (write a path, wait for the
    answer) gets single-query latency and a backlog is served in batches.

    On a device that captures graphs the loop first runs warm_serving,
    printing nothing, so that the first request of each warm key replays
    a captured graph (the counterpart of the JAX package's persistent
    compile cache, which a `warmup` process fills for later ones).  The
    graph captures of the warm-up and of the serving loop are recorded
    in `stages`' metadata (--json-metrics: listen_graph_captures).

    A bad request must not end the service: decode and load errors are
    reported as "Error reading <name>: ..." (fail_on_error is off for the
    loop and restored after it).  Any other error, a CUDA one included,
    propagates."""
    stream = stream if stream is not None else sys.stdin
    c0 = graphs.counts["captures"]
    if graphs.captures(analyzer.device):
        # silent: the matcher's notes would add lines to the output
        verbose, matcher.verbose = matcher.verbose, 0
        try:
            with stages.time("warm"):
                warm_serving(ht, analyzer, matcher, args, lambda msg: None)
        finally:
            matcher.verbose = verbose
    c1 = graphs.counts["captures"]
    prev_fail = analyzer.fail_on_error
    analyzer.fail_on_error = False
    n_files, tot_dur = 0, 0.0
    lines: queue.Queue = queue.Queue()
    eof_mark = object()

    def _reader():
        for line in stream:
            lines.put(line)
        lines.put(eof_mark)

    threading.Thread(target=_reader, daemon=True).start()
    cap = max(1, args.batchsize)
    eof = False
    try:
        while not eof:
            item = lines.get()
            if item is eof_mark:
                break
            names = []
            while True:
                name = item.strip()
                if name:
                    names.append(name)
                if len(names) >= cap:
                    break
                try:
                    item = lines.get_nowait()
                except queue.Empty:
                    break
                if item is eof_mark:
                    eof = True
                    break
            if not names:
                continue
            n, d = do_match(ht, analyzer, matcher, names, args, report,
                            stages)
            n_files += n
            tot_dur += d
            (out_f or sys.stdout).flush()
    finally:
        analyzer.fail_on_error = prev_fail
        stages.add_meta(listen_graph_captures={
            "warm": c1 - c0, "serving": graphs.counts["captures"] - c1})
    return n_files, tot_dur


def _start_profile(device):
    """A started torch.profiler session: host activity, plus CUDA activity
    (CUPTI) on a CUDA device."""
    import torch.profiler as tp

    acts = [tp.ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        acts.append(tp.ProfilerActivity.CUDA)
    prof = tp.profile(activities=acts)
    prof.start()
    return prof


def main(argv=None, device=None) -> int:
    """Run one CLI command.  `device` selects the torch device (None =
    CUDA, which must be present)."""
    # intermixed: files may follow options on every Python version
    args = make_parser().parse_intermixed_args(argv)
    cmd = args.command
    if args.shifts == 0:
        args.shifts = 1
    if args.windowed > 0 and args.speed_sweep > 0:
        # the sweep needs decoded samples per variant; windows are sliced
        # in the hash domain after one fingerprint pass
        print("--windowed cannot be combined with --speed-sweep",
              file=sys.stderr)
        return 2
    if cmd in ("new", "newmerge", "add", "match", "merge", "list",
               "remove", "warmup") and not args.dbase:
        print("a --dbase is required for " + cmd, file=sys.stderr)
        return 2
    if cmd in ("new", "newmerge"):
        ht = _new_table(args)
    elif cmd in ("add", "match", "merge", "list", "remove", "warmup"):
        ht = HashTable(args.dbase)
    else:
        ht = None

    out_f = open(args.opfile, "w") if args.opfile else None
    report_lock = threading.Lock()

    def report(msg: str) -> None:
        # thread-safe: the decode-prefetch worker can emit error lines
        with report_lock:
            if out_f is not None:
                out_f.write(msg + "\n")
            else:
                print(msg)

    prof = None
    tracer_was_on = timing.TRACER.on
    try:
        stages = Stages()
        if args.json_metrics:
            timing.TRACER.reset()
            timing.TRACER.on = True
        if args.profile:
            os.makedirs(args.profile, exist_ok=True)
            prof = _start_profile(device)
        t0 = time.time()
        n_files, tot_dur = 0, 0.0
        names = list(filename_list_iterator(
            args.file, args.wavdir, args.wavext, args.listflag))
        if cmd in ("new", "add", "precompute", "match", "warmup"):
            analyzer = setup_analyzer(args, device)
        if cmd in ("new", "add"):
            if cmd == "add":
                _check_params(ht, analyzer, report)
            n_files, tot_dur = do_ingest(ht, analyzer, names, args, report,
                                         stages)
            with stages.time("save"):
                ht.save(args.dbase, params=analyzer.params_dict())
        elif cmd == "precompute":
            n_files, tot_dur = do_precompute(analyzer, names, args, report)
        elif cmd == "match":
            _check_params(ht, analyzer, report)
            matcher = setup_matcher(args, device)
            if args.listen:
                n_files, tot_dur = do_listen(ht, analyzer, matcher, args,
                                             report, stages, out_f)
            else:
                n_files, tot_dur = do_match(ht, analyzer, matcher, names,
                                            args, report, stages)
        elif cmd in ("merge", "newmerge"):
            do_merge(ht, names, args, report, stages, device)
            with stages.time("save"):
                ht.save(args.dbase)
        elif cmd == "warmup":
            _check_params(ht, analyzer, report)
            n = do_warmup(ht, analyzer, setup_matcher(args, device), args,
                          report)
            report(f"warmup: {n} serving graphs compiled/cached in "
                   f"{time.time() - t0:.1f} s")
        elif cmd == "list":
            ht.list(report)
        elif cmd == "remove":
            for name in names:
                ht.remove(name)
                report(f"removed {name}")
            ht.save(args.dbase)

        elapsed = time.time() - t0
        if prof is not None:
            prof.stop()
            prof.export_chrome_trace(os.path.join(
                args.profile, f"audfprint_torch.{os.getpid()}.trace.json"))
            prof = None
            report(f"profiler trace written to {args.profile}")
        if cmd in ("new", "add", "precompute", "match") and args.verbose:
            ratio = elapsed / tot_dur if tot_dur > 0 else 0.0
            report(f"Processed {n_files} files ({tot_dur:.1f} s total dur) "
                   f"in {elapsed:.1f} s sec = {ratio:.3f} x RT")
        if args.verbose > 1:
            stages.report(report)
        if args.json_metrics:
            stages.add_meta(command=cmd, n_files=n_files,
                            total_dur_s=round(tot_dur, 3),
                            elapsed_s=round(elapsed, 3),
                            kernel_launches={
                                k: n for d in pipe.launch_counters()
                                for k, n in d.items()},
                            graphs=dict(graphs.counts),
                            **timing.TRACER.summary())
            stages.dump_json(args.json_metrics)
    finally:
        timing.TRACER.on = tracer_was_on
        if prof is not None:         # a command raised: end the session
            prof.stop()
        if out_f is not None:
            out_f.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
