"""ctypes binding to the native host runtime (native/libtlz4.so).

The native library is the production single-stream path: the streaming
frame encoder/decoder used by the CLIs, and the block-level entry points
(match/parse/emit/sequence-split) that form the host side of the hybrid
device pipeline.  Built on demand with `make -C native` (g++ only, no deps).
"""
from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import threading

import numpy as np

from . import format as fmt

_NATIVE_DIR = pathlib.Path(__file__).resolve().parent.parent / "native"
_LIB_PATH = _NATIVE_DIR / "libtlz4.so"
_lock = threading.Lock()
_lib = None

_ERRORS = {
    -1: "bad argument",
    -2: "output buffer too small",
    -3: "invalid signature",
    -4: "only LZ4 file format version 1 supported",
    -5: "invalid offset",
    -6: "out of data",
    -7: "checksum mismatch",
}


def _raise(code: int):
    msg = _ERRORS.get(code, f"native error {code}")
    if code in (-3, -4, -5, -6, -7):
        raise fmt.FormatError(msg)
    raise ValueError(msg)


def _build() -> bool:
    if not (_NATIVE_DIR / "Makefile").exists():
        return False
    res = subprocess.run(["make", "-C", str(_NATIVE_DIR), "-s"],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"native build failed:\n{res.stderr}")
    return _LIB_PATH.exists()


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not _LIB_PATH.exists() and not _build():
            return None
        lib = ctypes.CDLL(str(_LIB_PATH))
        c_u8p = ctypes.POINTER(ctypes.c_uint8)
        c_i32p = ctypes.POINTER(ctypes.c_int32)
        i64 = ctypes.c_int64
        lib.tlz4_enc_new.restype = ctypes.c_void_p
        lib.tlz4_enc_new.argtypes = [ctypes.c_int, ctypes.c_int, c_u8p, i64, i64]
        lib.tlz4_enc_new2.restype = ctypes.c_void_p
        lib.tlz4_enc_new2.argtypes = [ctypes.c_int, ctypes.c_int, c_u8p, i64, i64, ctypes.c_int]
        lib.tlz4_enc_free.argtypes = [ctypes.c_void_p]
        lib.tlz4_enc_write.restype = i64
        lib.tlz4_enc_write.argtypes = [ctypes.c_void_p, c_u8p, i64, ctypes.c_int, c_u8p, i64]
        lib.tlz4_enc_bound.restype = i64
        lib.tlz4_enc_bound.argtypes = [ctypes.c_void_p, i64]
        lib.tlz4_dec_new.restype = ctypes.c_void_p
        lib.tlz4_dec_new.argtypes = [c_u8p, i64]
        lib.tlz4_dec_new2.restype = ctypes.c_void_p
        lib.tlz4_dec_new2.argtypes = [c_u8p, i64, ctypes.c_int]
        lib.tlz4_xxh32.restype = ctypes.c_uint32
        lib.tlz4_xxh32.argtypes = [c_u8p, i64, ctypes.c_uint32]
        lib.tlz4_dec_free.argtypes = [ctypes.c_void_p]
        lib.tlz4_dec_write.restype = i64
        lib.tlz4_dec_write.argtypes = [ctypes.c_void_p, c_u8p, i64, ctypes.c_int, c_u8p, i64, ctypes.POINTER(ctypes.c_int)]
        lib.tlz4_compress_bound.restype = i64
        lib.tlz4_compress_bound.argtypes = [i64]
        lib.tlz4_compress.restype = i64
        lib.tlz4_compress.argtypes = [c_u8p, i64, c_u8p, i64, ctypes.c_int, ctypes.c_int, c_u8p, i64, i64]
        lib.tlz4_decompress.restype = i64
        lib.tlz4_decompress.argtypes = [c_u8p, i64, c_u8p, i64, c_u8p, i64]
        lib.tlz4_rdec_new.restype = ctypes.c_void_p
        lib.tlz4_rdec_new.argtypes = [c_u8p, i64, ctypes.c_int]
        lib.tlz4_rdec_free.argtypes = [ctypes.c_void_p]
        lib.tlz4_rdec_write.restype = i64
        lib.tlz4_rdec_write.argtypes = [ctypes.c_void_p, c_u8p, i64, ctypes.c_int,
                                        c_u8p, i64, ctypes.POINTER(ctypes.c_int64),
                                        ctypes.POINTER(ctypes.c_int)]
        lib.tlz4_match_block.restype = i64
        lib.tlz4_match_block.argtypes = [c_u8p, i64, i64, i64, ctypes.c_int, i64, c_i32p, c_i32p]
        lib.tlz4_match_block_ex.restype = i64
        lib.tlz4_match_block_ex.argtypes = [c_u8p, i64, i64, i64, ctypes.c_int, i64, i64, c_i32p, c_i32p]
        lib.tlz4_match_block_ex2.restype = i64
        lib.tlz4_match_block_ex2.argtypes = [c_u8p, i64, i64, i64, ctypes.c_int, i64, i64, i64, c_i32p, c_i32p]
        lib.tlz4_match_refine.restype = i64
        lib.tlz4_match_refine.argtypes = [c_u8p, i64, i64, i64, i64, i64, c_u8p, c_i32p, c_i32p]
        lib.tlz4_match_refine2.restype = i64
        lib.tlz4_match_refine2.argtypes = [c_u8p, i64, i64, i64, i64, i64, c_u8p, c_i32p, c_i32p, c_i32p]
        lib.tlz4_chosen.restype = i64
        lib.tlz4_chosen.argtypes = [c_i32p, i64, c_u8p]
        lib.tlz4_estimate_costs.restype = i64
        lib.tlz4_estimate_costs.argtypes = [c_i32p, c_i32p, i64]
        lib.tlz4_unpack_claims.restype = i64
        lib.tlz4_unpack_claims.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), c_i32p, i64, i64, c_i32p, c_i32p]
        lib.tlz4_emit_block.restype = i64
        lib.tlz4_emit_block.argtypes = [c_u8p, i64, c_i32p, c_i32p, c_u8p, i64]
        lib.tlz4_parse_sequences.restype = i64
        lib.tlz4_parse_sequences.argtypes = [c_u8p, i64, c_i32p, c_i32p, c_i32p, c_i32p, i64]
        lib.tlz4_decode_block.restype = i64
        lib.tlz4_decode_block.argtypes = [c_u8p, i64, c_u8p, i64, c_u8p, i64]
        lib.tlz4_version.restype = ctypes.c_char_p
        _lib = lib
        return _lib


def available() -> bool:
    try:
        return _load() is not None
    except RuntimeError:
        return False


def _u8(buf) -> np.ndarray:
    if isinstance(buf, np.ndarray):
        return np.ascontiguousarray(buf, dtype=np.uint8)
    return np.frombuffer(bytes(buf) if not isinstance(buf, (bytes, bytearray, memoryview)) else buf, dtype=np.uint8)


def _ptr(arr: np.ndarray):
    if arr.size == 0:
        return None
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _ptr32(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


# ---------------------------------------------------------------------------
# one-shot API
# ---------------------------------------------------------------------------

def compress(data, level=9, legacy=False, dictionary=None, block_size=None,
             content_checksum=False, block_checksum=False) -> bytes:
    if content_checksum or block_checksum:
        with Encoder(level=level, legacy=legacy, dictionary=dictionary,
                     block_size=block_size, content_checksum=content_checksum,
                     block_checksum=block_checksum) as enc:
            return enc.write(data, final=True)
    lib = _load()
    if legacy and dictionary:
        raise ValueError("legacy format doesn't support dictionaries")
    if legacy and level == 0:
        raise ValueError("legacy format doesn't support uncompressed files")
    fmt.level_to_max_chain(level)  # validate
    src = _u8(data)
    d = _u8(dictionary) if dictionary else np.zeros(0, np.uint8)
    cap = lib.tlz4_compress_bound(len(src))
    dst = np.empty(cap, np.uint8)
    r = lib.tlz4_compress(_ptr(src), len(src), _ptr(dst), cap,
                          level, int(legacy), _ptr(d), len(d),
                          block_size or 0)
    if r < 0:
        _raise(r)
    return dst[:r].tobytes()


def xxh32(data, seed: int = 0) -> int:
    lib = _load()
    b = _u8(data)
    return int(lib.tlz4_xxh32(_ptr(b), len(b), seed))


def decompress(data, dictionary=None, verify=False) -> bytes:
    if not verify:
        # one-shot fast path: single native call, zero staging copies;
        # geometric retry covers high-ratio frames (output size is not in
        # the header — smallz4cat.c:150 skips content size too).  The retry
        # allocation is capped at 1 GiB: past that the streaming decoder
        # takes over and grows output in pieces instead of one huge buffer.
        lib = _load()
        if lib is not None:
            src = _u8(data)
            d = _u8(dictionary) if dictionary else np.zeros(0, np.uint8)
            cap = max(4 * len(src), 1 << 16)
            while cap <= 1 << 30:
                out = np.empty(cap, np.uint8)
                r = lib.tlz4_decompress(_ptr(src), len(src), _ptr(out), cap,
                                        _ptr(d) if len(d) else None, len(d))
                if r == -2:  # output cap too small
                    cap *= 4
                    continue
                if r < 0:
                    _raise(r)
                return out[:r].tobytes()
    with Decoder(dictionary=dictionary, verify=verify) as dec:
        out = dec.write(data, final=True)
        if not dec.done:
            raise fmt.FormatError("out of data")
        return out


# ---------------------------------------------------------------------------
# streaming contexts (CLI path)
# ---------------------------------------------------------------------------

class Encoder:
    """Streaming frame encoder: feed chunks, receive compressed bytes."""

    def __init__(self, level=9, legacy=False, dictionary=None, block_size=None,
                 content_checksum=False, block_checksum=False):
        self._lib = _load()
        if self._lib is None:
            raise RuntimeError("native runtime not built")
        d = _u8(dictionary) if dictionary else np.zeros(0, np.uint8)
        flags = (1 if content_checksum else 0) | (2 if block_checksum else 0)
        self._h = self._lib.tlz4_enc_new2(level, int(legacy), _ptr(d), len(d),
                                          block_size or 0, flags)
        if not self._h:
            raise ValueError("invalid encoder parameters")

    def write(self, chunk, final: bool = False) -> bytes:
        src = _u8(chunk)
        cap = self._lib.tlz4_enc_bound(self._h, len(src))
        out = np.empty(cap, np.uint8)
        r = self._lib.tlz4_enc_write(self._h, _ptr(src), len(src), int(final),
                                     _ptr(out), cap)
        if r < 0:
            _raise(r)
        return out[:r].tobytes()

    def close(self):
        if self._h:
            self._lib.tlz4_enc_free(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Decoder:
    """Streaming frame decoder: feed compressed chunks, receive output."""

    OUT_CAP = (8 << 20) + (1 << 16)  # largest legacy block + slack

    def __init__(self, dictionary=None, verify=False):
        self._lib = _load()
        if self._lib is None:
            raise RuntimeError("native runtime not built")
        d = _u8(dictionary) if dictionary else np.zeros(0, np.uint8)
        self._h = self._lib.tlz4_dec_new2(_ptr(d), len(d), int(verify))
        self._out = np.empty(self.OUT_CAP, np.uint8)
        self.done = False

    def write(self, chunk, final: bool = False) -> bytes:
        src = _u8(chunk)
        pieces = []
        off = 0
        flag = ctypes.c_int(0)
        # feed in slices so a burst of many blocks can't overflow out_cap
        while True:
            take = min(len(src) - off, 4 << 20)
            r = self._lib.tlz4_dec_write(
                self._h, _ptr(src[off:off + take]) if take else None, take,
                int(final and off + take == len(src)),
                _ptr(self._out), self.OUT_CAP, ctypes.byref(flag))
            if r < 0:
                _raise(r)
            pieces.append(self._out[:r].tobytes())
            off += take
            self.done = bool(flag.value)
            if off >= len(src):
                # drain: repeat zero-length writes while full buffers come out
                if r > 0 and not self.done:
                    continue
                break
        return b"".join(pieces)

    def close(self):
        if self._h:
            self._lib.tlz4_dec_free(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RingDecoder:
    """Constant-memory streaming decoder: 64 KB ring + 16-byte stash, no
    input retention (the reference's memory profile, smallz4cat.c:73,
    162-166).  write() consumes the chunk fully, emitting output pieces of
    at most ``out_chunk`` bytes; total live memory is O(64 KB) regardless
    of frame size."""

    def __init__(self, dictionary=None, verify=False, out_chunk: int = 1 << 16):
        self._lib = _load()
        if self._lib is None:
            raise RuntimeError("native runtime not built")
        d = _u8(dictionary) if dictionary else np.zeros(0, np.uint8)
        self._h = self._lib.tlz4_rdec_new(_ptr(d), len(d), int(verify))
        self._out = np.empty(out_chunk, np.uint8)
        self.done = False

    def chunks(self, chunk, final: bool = False):
        """Yield decoded pieces for this input chunk (each <= out_chunk)."""
        src = _u8(chunk)
        off = 0
        consumed = ctypes.c_int64(0)
        flag = ctypes.c_int(0)
        while True:
            n = len(src) - off
            r = self._lib.tlz4_rdec_write(
                self._h, _ptr(src[off:]) if n else None, n,
                int(final), _ptr(self._out), len(self._out),
                ctypes.byref(consumed), ctypes.byref(flag))
            if r < 0:
                _raise(r)
            if r:
                yield self._out[:r].tobytes()
            off += consumed.value
            self.done = bool(flag.value)
            if self.done or (off >= len(src) and r == 0):
                break

    def write(self, chunk, final: bool = False) -> bytes:
        return b"".join(self.chunks(chunk, final))

    def close(self):
        if self._h:
            self._lib.tlz4_rdec_free(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# block-level entry points (device hybrid path)
# ---------------------------------------------------------------------------

def match_block(buf, base: int, bs: int, level: int, lookback: int = 0):
    """Per-position (len, dist) match arrays for one block with context."""
    lib = _load()
    b = _u8(buf)
    lens = np.zeros(bs, np.int32)
    dists = np.zeros(bs, np.int32)
    r = lib.tlz4_match_block(_ptr(b), len(b), base, bs, level, lookback,
                             _ptr32(lens), _ptr32(dists))
    if r < 0:
        _raise(r)
    return lens, dists


def match_block_ex(buf, base: int, bs: int, level: int, lookback: int,
                   cut_pos: int, lens: np.ndarray, dists: np.ndarray) -> None:
    """Match search into caller-provided arrays, with an explicit boundary
    chain-cut position (thread-pool friendly: no allocations)."""
    lib = _load()
    b = _u8(buf)
    r = lib.tlz4_match_block_ex(_ptr(b), len(b), base, bs, level, lookback,
                                cut_pos, _ptr32(lens), _ptr32(dists))
    if r < 0:
        _raise(r)


def match_chunk(buf, base: int, bs: int, level: int, lookback: int,
                cut_pos: int, block_end: int,
                lens: np.ndarray, dists: np.ndarray) -> None:
    """Match search for chunk [base, base+bs) of a block ending at
    ``block_end`` (intra-block parallelism, levels 7-9 only)."""
    lib = _load()
    b = _u8(buf)
    r = lib.tlz4_match_block_ex2(_ptr(b), len(b), base, bs, level, lookback,
                                 cut_pos, block_end, _ptr32(lens), _ptr32(dists))
    if r < 0:
        _raise(r)


def match_refine(buf, base: int, bs: int, lookback: int,
                 mask: np.ndarray, lens: np.ndarray, dists: np.ndarray,
                 cut_pos: int = -1) -> None:
    """Re-run the level-9 search at masked positions only, in place.
    ``cut_pos``: boundary chain-cut position (base-12 for carried-history
    blocks of a standard frame, -1 for none)."""
    lib = _load()
    b = _u8(buf)
    m = np.ascontiguousarray(mask, dtype=np.uint8)
    r = lib.tlz4_match_refine(_ptr(b), len(b), base, bs, lookback, cut_pos,
                              _ptr(m), _ptr32(lens), _ptr32(dists))
    if r < 0:
        _raise(r)


def match_refine_dist(buf, base: int, bs: int, lookback: int,
                      mask: np.ndarray, targets: np.ndarray,
                      lens: np.ndarray, dists: np.ndarray,
                      cut_pos: int = -1) -> None:
    """Distance-only refine at masked positions: ``targets`` holds each
    position's certified exact max length (the device LK certificate);
    the walk early-stops at the first achiever = the reference's
    nearest-of-max.  Writes lens (== targets) and dists in place."""
    lib = _load()
    b = _u8(buf)
    m = np.ascontiguousarray(mask, dtype=np.uint8)
    t = np.ascontiguousarray(targets, dtype=np.int32)
    r = lib.tlz4_match_refine2(_ptr(b), len(b), base, bs, lookback, cut_pos,
                               _ptr(m), _ptr32(t), _ptr32(lens), _ptr32(dists))
    if r < 0:
        _raise(r)


def chosen_mask(lens: np.ndarray) -> np.ndarray:
    """Match starts of a DP-shortened lens array (the emitter's walk):
    bool mask, True where a match is emitted."""
    lib = _load()
    assert lens.dtype == np.int32
    out = np.zeros(len(lens), np.uint8)
    r = lib.tlz4_chosen(_ptr32(lens), len(lens), _ptr(out))
    if r < 0:
        _raise(r)
    return out.astype(bool)


def unpack_claims(bits: np.ndarray, packed: np.ndarray, n: int):
    """Expand one chunk's head/delta packing (ops.chunkmatch.pack_results)
    into per-position (lens, dists) int32 arrays — the fast native inverse
    of the device packer (memory-speed decay fill)."""
    import ctypes as _ct

    lib = _load()
    b = np.ascontiguousarray(bits, dtype=np.uint32)
    p = np.ascontiguousarray(packed, dtype=np.int32)
    lens = np.empty(n, np.int32)
    dists = np.empty(n, np.int32)
    r = lib.tlz4_unpack_claims(
        b.ctypes.data_as(_ct.POINTER(_ct.c_uint32)), _ptr32(p), len(p), n,
        _ptr32(lens), _ptr32(dists))
    if r < 0:
        _raise(r)
    return lens, dists


def estimate_costs(lens: np.ndarray, dists: np.ndarray) -> None:
    lib = _load()
    assert lens.dtype == np.int32 and dists.dtype == np.int32
    r = lib.tlz4_estimate_costs(_ptr32(lens), _ptr32(dists), len(lens))
    if r < 0:
        _raise(r)


def emit_block(block, lens: np.ndarray, dists: np.ndarray) -> bytes:
    lib = _load()
    b = _u8(block)
    cap = len(b) + len(b) // 255 + 64
    out = np.empty(cap, np.uint8)
    r = lib.tlz4_emit_block(_ptr(b), len(b), _ptr32(lens), _ptr32(dists),
                            _ptr(out), cap)
    if r < 0:
        _raise(r)
    return out[:r].tobytes()


def parse_sequences(payload):
    """Split a compressed block payload into its sequence table."""
    lib = _load()
    p = _u8(payload)
    max_seq = len(p) + 2
    lit_len = np.empty(max_seq, np.int32)
    match_len = np.empty(max_seq, np.int32)
    match_off = np.empty(max_seq, np.int32)
    lit_src = np.empty(max_seq, np.int32)
    r = lib.tlz4_parse_sequences(_ptr(p), len(p), _ptr32(lit_len),
                                 _ptr32(match_len), _ptr32(match_off),
                                 _ptr32(lit_src), max_seq)
    if r < 0:
        _raise(r)
    return lit_len[:r], match_len[:r], match_off[:r], lit_src[:r]


def decode_block(payload, hist=b"", out_cap: int | None = None) -> bytes:
    lib = _load()
    p = _u8(payload)
    h = _u8(hist)
    cap = out_cap or (len(p) * 256 + (1 << 16))
    out = np.empty(cap, np.uint8)
    r = lib.tlz4_decode_block(_ptr(p), len(p), _ptr(h), len(h), _ptr(out), cap)
    if r < 0:
        _raise(r)
    return out[:r].tobytes()
