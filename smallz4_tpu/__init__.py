"""smallz4_tpu — a device-accelerated LZ4 codec framework.

A from-scratch re-design of the capabilities of gbonneau-hardent/smallz4
(optimal-parse LZ4 encoder + streaming decoder) for an accelerator (an
NVIDIA GPU): JAX/XLA code for the block codec, a native C++ host runtime
for the serial byte-stream glue, and jax.sharding for multi-device
scale-out.

Public API (mirrors the reference's two capabilities — smallz4.h:31-37,
smallz4cat.c:363-366 — in idiomatic Python, plus in-memory variants):

    compress(data, level=9, legacy=False, dictionary=None) -> bytes
    decompress(data, dictionary=None) -> bytes
    open_frame(...)  # streaming interfaces in smallz4_tpu.utils.io
"""
from . import format  # noqa: F401
from .format import VERSION, FormatError  # noqa: F401


def get_version() -> str:
    """Behavioral parity version (reference: smallz4.h:67-70)."""
    return VERSION


def compress(data, level: int = 9, legacy: bool = False, dictionary=None,
             block_size=None, engine: str = "auto") -> bytes:
    """Compress to a complete LZ4 frame. ``engine``: 'auto' | 'native' |
    'tpu' | 'oracle'."""
    from .codec import compress as _compress
    return _compress(data, level=level, legacy=legacy, dictionary=dictionary,
                     block_size=block_size, engine=engine)


def decompress(data, dictionary=None, engine: str = "auto") -> bytes:
    """Decompress a complete LZ4 frame (modern or legacy)."""
    from .codec import decompress as _decompress
    return _decompress(data, dictionary=dictionary, engine=engine)


def decompress_batch(frames, dictionary=None, engine: str = "auto") -> list:
    """Decode many independent frames; engine='tpu' batches block
    expansions across frames in one vmapped device dispatch."""
    from .codec import decompress_batch as _db
    return _db(frames, dictionary=dictionary, engine=engine)
