"""Command-line interface (port of audfprint_tpu/cli.py, single device).

Same commands (new | add | precompute | merge | newmerge | match | list |
remove), same flags and defaults, same output lines.  Ingest and match run
batched on one device with the host HashTable store and the host merge;
`--device-store` keeps the table on the device during new/add
(models/ingest.py), and WAVs longer than `--stream-above` seconds are
analysed in chunks of `--stream-chunk` frames (models/streaming.py).
Flags of the JAX CLI whose machinery is not ported yet (--ndev > 1,
warmup, --listen, --windowed, --speed-sweep, --illustrate,
--illustrate-hpf, --sonify, --profile, wide --idbits tables) exit with
status 2 and a message pointing at ROADMAP.md.

The device is a keyword of `main` (CUDA by default), so tests can drive
the CLI on the CPU: `main(argv, device="cpu")`.
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from audfprint_tpu import params as P
from audfprint_tpu.index.hash_table import HashTable
from audfprint_tpu.utils import audio as audio_io
from audfprint_tpu.utils import formats
from audfprint_tpu.utils.timing import Stages
from audfprint_torch.match.matcher import Matcher
from audfprint_torch.models.analyzer import Analyzer
from audfprint_torch.models.ingest import DeviceIngest
from audfprint_torch.ops import cuda_peaks as CP
from audfprint_torch.ops import spectro as SP

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
      help="devices for store/match (only 1 is ported)")
    a("--idbits", type=int, default=0,
      help="track-id bits of the entry packing (0 = 32 - maxtimebits; "
           "wide tables past 32 bits are not ported)")
    a("--device-store", dest="device_store", action="store_true",
      help="new/add: keep the hash table on the device and fingerprint + "
           "store each chunk in one pass; the saved database equals the "
           "host store's")
    a("--speed-sweep", dest="speed_sweep", type=float, default=0.0,
      help="not yet ported")
    a("--windowed", type=float, default=0.0, metavar="SEC",
      help="not yet ported")
    a("--window-hop", dest="window_hop", type=float, default=0.0,
      metavar="SEC", help="not yet ported")
    a("--warm-durations", dest="warm_durations", type=str, default="5,10",
      help="not yet ported")
    a("--listen", action="store_true", help="not yet ported")
    a("--stream-above", dest="stream_above", type=float, default=3600.0,
      metavar="SEC",
      help="WAV inputs longer than SEC analyse in fixed-size chunks with "
           "O(chunk) host and device memory (carried HPF and envelope "
           "state, exact sparse backward prune); 0 disables streaming")
    a("--stream-chunk", dest="stream_chunk", type=int, default=8192,
      metavar="FRAMES",
      help="streamed ingest chunk size in analysis frames (~190 s at the "
           "defaults); results are identical at any value")
    a("--profile", type=str, default=None, help="not yet ported")
    a("--json-metrics", dest="json_metrics", type=str, default=None,
      help="write per-stage timing/counters JSON to this file")
    return p


def _unported(args) -> str | None:
    """The first requested feature this port does not have yet, or None."""
    checks = [
        (args.command == "warmup", "warmup"),
        (args.ndev not in (None, 1), "--ndev > 1"),
        (args.listen, "--listen"),
        (args.windowed > 0, "--windowed"),
        (args.speed_sweep > 0, "--speed-sweep"),
        (args.illustrate or args.illustrate_hpf or args.sonify,
         "--illustrate/--illustrate-hpf/--sonify"),
        (args.profile is not None, "--profile"),
    ]
    for hit, name in checks:
        if hit:
            return name
    return None


def _refuse(name: str) -> int:
    print(f"audfprint_torch: {name} is not yet ported; see ROADMAP.md "
          "(python -m audfprint_tpu has it)", file=sys.stderr)
    return 2


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


def do_merge(ht: HashTable, names: list, report, stages: Stages) -> None:
    """CLI merge/newmerge: the vectorised host merge, source by source."""
    for name in names:
        other = HashTable(name)
        with stages.time("merge"):
            ht.merge(other)
        report(f"merged {name} ({sum(1 for n in other.names if n)} files)")


def _decode_chunk(analyzer: Analyzer, args, report, chunk: list) -> list:
    """Decode one chunk -> (name, kind, payload) entries in input order.
    kind is "pre" (precomputed, loads later), "wav" (payload = decoded
    samples) or "stream" (a WAV past --stream-above, analysed chunk-wise
    right here with O(chunk) memory; payload = (hashes, duration))."""
    def _kind(n):
        if os.path.splitext(n)[1] in (formats.PRECOMPEXT,
                                      formats.PRECOMPPKEXT):
            return "pre"
        return "stream" if analyzer._should_stream(n) else "wav"

    kinds = [_kind(n) for n in chunk]
    wavs = [n for n, k in zip(chunk, kinds) if k == "wav"]
    signals = iter(_decode_many(analyzer, wavs, args.ncores, report))
    out = []
    for n, k in zip(chunk, kinds):
        if k == "wav":
            out.append((n, k, next(signals)))
        elif k == "stream":
            try:
                h = analyzer.wavfile2hashes_streaming(n)
                out.append((n, k, (h, analyzer.soundfiledur)))
            except (OSError, ValueError, audio_io.DecodeError) as e:
                if analyzer.fail_on_error:
                    raise
                report(f"Error reading {n}: {e}")
                out.append((n, k, None))
        else:
            out.append((n, k, None))
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
    and `consume(ordered, handle)` handles chunk i-1."""
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

    With --device-store each chunk is one fused fingerprint + store pass on
    the device and one small counts fetch (models/ingest.DeviceIngest; the
    hashes never reach the host); otherwise the fingerprints come to the
    host and go into the host table."""
    tot_dur = 0.0
    n_done = 0
    store = DeviceIngest(ht, analyzer) if args.device_store else None
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
    follow the input order.  Chunks of decoded audio take the fused
    fingerprint+match path; chunks holding precomputed inputs (or past
    the memory budget) fingerprint, then match the hashes."""
    tot_dur = 0.0
    n_done = 0
    B = max(1, args.batchsize)
    chunks = [names[i: i + B] for i in range(0, len(names), B)]

    def dispatch(ordered):
        sigs = _wav_signals(ordered)
        if sigs and len(sigs) == len(ordered):
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
            rows = [(name, r, len(d) / analyzer.target_sr, n)
                    for (name, _k, d), r, n in zip(ordered, res, nh)]
        else:
            with stages.time("analyze"):
                hashes = iter(analyzer.fingerprint_resolve(payload))
            hrows = _resolve_chunk(analyzer, ordered, hashes, report)
            with stages.time("match"):
                res = matcher.match_hashes_batch(ht, [h for _, h, _ in hrows])
            rows = [(name, r, dur, len(h))
                    for (name, h, dur), r in zip(hrows, res)]
        for name, rrows, dur, nh in rows:
            for msg in matcher.results_to_msgs(rrows, dur, nh, analyzer, ht,
                                               name):
                report(msg)
            tot_dur += dur
            n_done += 1

    _run_pipelined(chunks, analyzer, args, report, stages, consume, dispatch)
    return n_done, tot_dur


def main(argv=None, device=None) -> int:
    """Run one CLI command.  `device` selects the torch device (None =
    CUDA, which must be present)."""
    # intermixed: files may follow options on every Python version
    args = make_parser().parse_intermixed_args(argv)
    cmd = args.command
    if args.shifts == 0:
        args.shifts = 1
    name = _unported(args)
    if name is not None:
        return _refuse(name)
    if cmd in ("new", "newmerge", "add", "match", "merge", "list",
               "remove") and not args.dbase:
        print("a --dbase is required for " + cmd, file=sys.stderr)
        return 2
    if cmd in ("new", "newmerge"):
        ht = _new_table(args)
    elif cmd in ("add", "match", "merge", "list", "remove"):
        ht = HashTable(args.dbase)
    else:
        ht = None
    if ht is not None and ht.wide:
        return _refuse("a wide-entry table (--idbits)")

    out_f = open(args.opfile, "w") if args.opfile else None
    report_lock = threading.Lock()

    def report(msg: str) -> None:
        # thread-safe: the decode-prefetch worker can emit error lines
        with report_lock:
            if out_f is not None:
                out_f.write(msg + "\n")
            else:
                print(msg)

    try:
        stages = Stages()
        t0 = time.time()
        n_files, tot_dur = 0, 0.0
        names = list(filename_list_iterator(
            args.file, args.wavdir, args.wavext, args.listflag))
        if cmd in ("new", "add", "precompute", "match"):
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
            n_files, tot_dur = do_match(ht, analyzer,
                                        setup_matcher(args, device), names,
                                        args, report, stages)
        elif cmd in ("merge", "newmerge"):
            do_merge(ht, names, report, stages)
            with stages.time("save"):
                ht.save(args.dbase)
        elif cmd == "list":
            ht.list(report)
        elif cmd == "remove":
            for name in names:
                ht.remove(name)
                report(f"removed {name}")
            ht.save(args.dbase)

        elapsed = time.time() - t0
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
                            kernel_launches={**SP.launches, **CP.launches})
            stages.dump_json(args.json_metrics)
    finally:
        if out_f is not None:
            out_f.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
