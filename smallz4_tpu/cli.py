"""Compressor CLI — flag/semantics parity with the reference CLI
(smallz4.cpp:120-326): levels -0..-9, -f overwrite, -l legacy, -D dict,
-v verbose, bundled flags (-f7), stdin/stdout defaults, '-' placeholder,
overwrite guard, legacy restrictions, bare-invocation help on a tty."""
from __future__ import annotations

import os
import sys
import time

from . import format as fmt
from .utils import io as uio
from .utils.progress import Progress

PROGRAM = "smallz4-tpu"


def show_help(out=sys.stdout) -> None:
    print(
        f"""smalLZ4-tpu {fmt.VERSION}: device-accelerated compressor with optimal parsing, fully compatible with LZ4 by Yann Collet (see https://lz4.org)

Basic usage:
  {PROGRAM} [flags] [input] [output]

This program writes to STDOUT if output isn't specified
and reads from STDIN if input isn't specified, either.

Examples:
  {PROGRAM}   < abc.txt > abc.txt.lz4    # use STDIN and STDOUT
  {PROGRAM}     abc.txt > abc.txt.lz4    # read from file and write to STDOUT
  {PROGRAM}     abc.txt   abc.txt.lz4    # read from and write to file
  cat abc.txt | {PROGRAM} - abc.txt.lz4  # read from STDIN and write to file
  {PROGRAM} -6  abc.txt   abc.txt.lz4    # compression level 6 (instead of default 9)
  {PROGRAM} -f  abc.txt   abc.txt.lz4    # overwrite an existing file
  {PROGRAM} -f7 abc.txt   abc.txt.lz4    # compression level 7 and overwrite an existing file

Flags:
  -0, -1 ... -9   Set compression level, default: 9 (see below)
  -h              Display this help message
  -f              Overwrite an existing file
  -l              Use LZ4 legacy file format
  -D [FILE]       Load dictionary
  -v              Verbose

Compression levels:
 -0               No compression
 -1 ... -{fmt.SHORT_CHAINS_GREEDY}        Greedy search, check 1 to {fmt.SHORT_CHAINS_GREEDY} matches
 -{fmt.SHORT_CHAINS_GREEDY + 1} ... -8        Lazy matching with optimal parsing, check {fmt.SHORT_CHAINS_GREEDY + 1} to 8 matches
 -9               Optimal parsing, check all possible matches (default)

Framework extensions (beyond the reference CLI):
  --engine=E      auto | native | tpu | host | oracle (tpu = the device
                  engine, on the GPU)
  --kernel=K      device search kernel: chunk | walk
  --unsafe-raw    tpu engine DIAGNOSTIC: keep raw device claims (skip
                  the exact host refine; output stays a valid stream but
                  the size may exceed -9 — not a product mode)
  --parity        tpu engine: bit-exact -9 streams (the default)
  --threads=N     host-parallel worker cap
  --block-size=N  frame block size in bytes
  --checksum      add content checksum (native engine, modern format)
  --profile=NAME  named codec profile (see models/profiles.py)
  --report        print a structured run report (JSON) on stderr
""",
        file=out,
    )


def error(msg: str, code: int = 1) -> "NoReturn":  # noqa: F821
    print(f"ERROR: {msg}", file=sys.stderr)
    raise SystemExit(code)


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)

    # bare invocation on a terminal prints help (smallz4.cpp:169-173)
    if not argv and sys.stdin.isatty():
        show_help()
        return 0

    level = 9
    overwrite = False
    legacy = False
    verbose = False
    dictionary_path: str | None = None
    engine = "auto"         # framework extension: --engine=native|tpu|host
    threads: int | None = None  # --threads=N (host-parallel engine)
    block_size: int | None = None  # --block-size=N
    content_checksum = False    # --checksum (spec content checksum)
    max_candidates = 16     # tpu engine search cap (profiles override)
    kernel = None           # --kernel=chunk|walk (device search kernel)
    parity = True           # tpu engine exact -9 streams (default)
    want_report = False     # --report: RunReport JSON on stderr

    # --profile applies first; explicit flags then override its fields
    for arg in argv:
        if arg.startswith("--profile="):
            from .models import profiles

            try:
                prof = profiles.get(arg[len("--profile="):])
            except ValueError as e:
                error(str(e))
            level, legacy, engine = prof.level, prof.legacy, prof.engine
            block_size, threads = prof.block_size, prof.threads
            max_candidates, parity = prof.max_candidates, prof.parity

    # hand-rolled scan supporting bundled flags like -f7 (smallz4.cpp:194-249)
    pos = 0
    positional: list[str] = []
    while pos < len(argv):
        arg = argv[pos]
        if arg.startswith("--"):
            key, _, val = arg[2:].partition("=")
            if key == "engine" and val in ("auto", "native", "tpu", "host", "oracle"):
                engine = val
            elif key == "kernel" and val in ("chunk", "walk"):
                kernel = val
            elif key == "threads" and val.isdigit():
                threads = int(val)
            elif key == "block-size" and val.isdigit():
                block_size = int(val)
            elif key == "checksum" and not val:
                content_checksum = True
            elif key == "report" and not val:
                want_report = True
            elif key == "profile" and val:
                pass  # applied in the pre-scan above
            elif key == "parity" and not val:
                parity = True
            elif key == "unsafe-raw" and not val:
                parity = False  # raw device claims: diagnostic only
            elif key == "fast" and not val:
                error("--fast was renamed --unsafe-raw: raw device claims "
                      "do not honor the <= -9 size contract (round-5 "
                      "naming fix; the default --parity mode is bit-exact)")
            else:
                error("unknown flag")
            pos += 1
            continue
        if arg.startswith("-") and arg != "-" and not positional:
            for ch in arg[1:]:
                if ch == "h":
                    show_help()
                    return 0
                elif ch == "f":
                    overwrite = True
                elif ch == "l":
                    legacy = True
                elif ch == "v":
                    verbose = True
                elif ch == "D":
                    if pos + 1 >= len(argv):
                        error("no dictionary filename found")
                    dictionary_path = argv[pos + 1]
                    pos += 1
                elif ch.isdigit():
                    level = int(ch)
                else:
                    error("unknown flag")
            pos += 1
            continue
        positional.append(arg)
        pos += 1

    # Surplus positionals are silently ignored, as the reference does;
    # its output-file branch fires only when that argument is the LAST
    # one (`argc == nextArgument + 1`, smallz4.cpp:261), so with three or
    # more positionals output falls back to stdout.
    in_path = positional[0] if len(positional) >= 1 else None
    out_path = positional[1] if len(positional) == 2 else None

    # legacy restrictions (smallz4.cpp:272-279)
    if legacy and dictionary_path is not None:
        error("legacy format doesn't support dictionaries")
    if legacy and level == 0:
        error("legacy format doesn't support uncompressed files")

    dictionary = None
    if dictionary_path is not None:
        try:
            dictionary = uio.load_dictionary(dictionary_path)
        except OSError:
            error("cannot open dictionary")

    try:
        src = uio.open_input(in_path)
    except OSError:
        error("file not found")
    try:
        dst = uio.open_output(out_path, force=overwrite)
    except FileExistsError:
        error("output file already exists")
    except OSError:
        error("cannot create file")

    total = 0
    if verbose and in_path not in (None, "-"):
        total = os.path.getsize(in_path)
    progress = Progress(verbose, total_size=total)

    from . import native
    if content_checksum and (legacy or engine in ("tpu", "host", "oracle")):
        error("--checksum requires the native engine and the modern format")
    report = None
    if want_report:
        from .utils.profiling import RunReport

        report = RunReport(operation="encode", engine=engine)
    if engine in ("tpu", "host", "oracle"):
        enc = _BufferedEncoder(engine, level, legacy, dictionary, block_size,
                               threads, max_candidates=max_candidates,
                               parity=parity, report=report, kernel=kernel,
                               progress=progress)
    elif native.available():
        enc = native.Encoder(level=level, legacy=legacy, dictionary=dictionary,
                             block_size=block_size,
                             content_checksum=content_checksum)
    else:
        enc = _OracleEncoder(level, legacy, dictionary)

    t0 = time.perf_counter()
    uio.pump(enc, src, dst, progress=progress)
    progress.summary()
    if report is not None:
        if not report.wall_s:  # engines that don't fill stages themselves
            report.wall_s = time.perf_counter() - t0
            report.bytes_in = progress.bytes_in
            report.bytes_out = progress.bytes_out
        print(report.to_json(), file=sys.stderr)
    return 0


class _BufferedEncoder:
    """Whole-buffer engines (tpu / host-parallel / oracle) behind the
    streaming pump interface."""

    def __init__(self, engine, level, legacy, dictionary, block_size, threads,
                 max_candidates=16, parity=False, report=None, kernel=None,
                 progress=None):
        self.engine, self.level, self.legacy = engine, level, legacy
        self.dictionary, self.block_size, self.threads = dictionary, block_size, threads
        self.max_candidates, self.parity, self.report = max_candidates, parity, report
        self.kernel = kernel
        self.progress = progress
        self.buf = bytearray()

    def _block_cb(self):
        """Per-block progress hook (reference -v parity: stderr updates as
        output is produced, smallz4.cpp:82-117) for the buffered engines."""
        p = self.progress
        if p is None or not p.enabled:
            return None

        def cb(done_in, done_out, _p=p):
            _p.bytes_out = done_out
            _p.report()

        return cb

    def write(self, chunk, final=False) -> bytes:
        self.buf += chunk
        if not final:
            return b""
        data = bytes(self.buf)
        cb = self._block_cb()
        try:
            if self.engine == "tpu":
                from .ops import pipeline
                return pipeline.compress(data, self.level, legacy=self.legacy,
                                         dictionary=self.dictionary,
                                         block_size=self.block_size,
                                         max_candidates=self.max_candidates,
                                         parity=self.parity, report=self.report,
                                         kernel=self.kernel, progress=cb)
            if self.engine == "host":
                if self.legacy:
                    error("host-parallel engine supports the modern format only")
                from .parallel import host
                return host.compress(data, self.level,
                                     block_size=self.block_size or 4 * 1024 * 1024,
                                     dictionary=self.dictionary,
                                     threads=self.threads, progress=cb)
        finally:
            if cb is not None:
                # the pump re-counts the returned frame through add_out
                self.progress.bytes_out = 0
        from . import oracle
        return oracle.compress(data, self.level, legacy=self.legacy,
                               dictionary=self.dictionary,
                               block_size=self.block_size)


class _OracleEncoder:
    """Whole-buffer fallback when the native runtime isn't built."""

    def __init__(self, level, legacy, dictionary):
        self.level, self.legacy, self.dictionary = level, legacy, dictionary
        self.buf = bytearray()

    def write(self, chunk, final=False) -> bytes:
        self.buf += chunk
        if not final:
            return b""
        from . import oracle
        return oracle.compress(bytes(self.buf), self.level, legacy=self.legacy,
                               dictionary=self.dictionary)


if __name__ == "__main__":
    raise SystemExit(main())
