"""Engine dispatch for the public compress/decompress API.

Engines:
  'oracle' — NumPy reference-exact scalar codec (smallz4_tpu.oracle); slow,
             used as the differential anchor.
  'native' — C++ host runtime (smallz4_tpu.native); fast single-stream path.
  'tpu'    — the device engine: JAX block-parallel path on the GPU
             (smallz4_tpu.ops / .parallel).
  'auto'   — native if built, else oracle.
"""
from __future__ import annotations

from . import oracle


def _native():
    try:
        from . import native
        return native if native.available() else None
    except Exception:
        return None


def compress(data, level=9, legacy=False, dictionary=None, block_size=None,
             engine="auto") -> bytes:
    if engine == "tpu":
        from .ops import pipeline
        return pipeline.compress(data, level=level, legacy=legacy,
                                 dictionary=dictionary, block_size=block_size)
    if engine in ("auto", "native"):
        nat = _native()
        if nat is not None:
            return nat.compress(data, level=level, legacy=legacy,
                                dictionary=dictionary, block_size=block_size)
        if engine == "native":
            raise RuntimeError("native runtime not built (run `make -C native`)")
    return oracle.compress(data, level=level, legacy=legacy,
                           dictionary=dictionary, block_size=block_size)


def decompress(data, dictionary=None, engine="auto") -> bytes:
    if engine == "tpu":
        from .ops import pipeline
        return pipeline.decompress(data, dictionary=dictionary)
    if engine in ("auto", "native"):
        nat = _native()
        if nat is not None:
            return nat.decompress(data, dictionary=dictionary)
        if engine == "native":
            raise RuntimeError("native runtime not built (run `make -C native`)")
    return oracle.decompress(data, dictionary=dictionary)


def decompress_batch(frames, dictionary=None, engine="auto") -> list:
    """Decode many independent frames.  'tpu' batches block expansions
    across frames in one vmapped device dispatch (decode parallelism
    across frames — ops.decoder.decompress_batch); 'auto'/'native' loop
    the fast host decoder."""
    if engine == "tpu":
        from .ops import decoder
        return decoder.decompress_batch(frames, dictionary=dictionary)
    return [decompress(f, dictionary=dictionary, engine=engine)
            for f in frames]
