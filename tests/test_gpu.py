"""Card-only checks (marker ``gpu``; they skip without a GPU).  The last
phase of chip_smoke.py runs every ``gpu``-marked test in process; by hand:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""
import numpy as np
import pytest

import bench
from smallz4_tpu import native
from smallz4_tpu.ops import chunkmatch as cm
from smallz4_tpu.parallel import sharding

pytestmark = pytest.mark.gpu


def _step_temp_bytes(n_local: int) -> int:
    step = sharding.sharded_chunk_step(sharding.make_mesh(1), n_local)
    rows = [np.zeros(n_local, np.int32)] * 5
    args = (np.zeros((n_local, cm.CHUNK + cm.LOOK), np.uint8), *rows,
            np.zeros(cm.CHUNK + cm.LOOK, np.uint8), np.int32(cm.CHUNK))
    return step.lower(*args).compile().memory_analysis().temp_size_in_bytes


def test_sharded_chunks_full_width_three_groups_on_one_card(gpu):
    """12 MB on a one-card mesh is 192 chunks, three 4 MB groups in the
    device's scan: byte-equal native, with the working memory of one
    group."""
    one, three = _step_temp_bytes(cm.GROUP), _step_temp_bytes(3 * cm.GROUP)
    print(f"sharded step temp: {one} B at {cm.GROUP} chunks, "
          f"{three} B at {3 * cm.GROUP}")
    assert three <= 1.1 * one
    x = bench.make_corpus(12 << 20)
    assert (sharding.compress_sharded_chunks(x, sharding.make_mesh(1))
            == native.compress(x, 9))
