"""Record sorts for the chunk matcher: plain ``lax.sort`` over planes.

Records are parallel 1-D planes.  The first ``n_keys`` planes are sort
keys compared as unsigned 32-bit words (int32 planes are viewed as
uint32 for the compare), then — unless the caller asserts the last key
is already distinct — the next plane (pos, a non-negative int32) breaks
ties, so the order is deterministic and equal to a stable sort (the
nearest-first chain contract, smallz4.h:651-653).  Any further planes
ride along as payload.

The reference has no counterpart component: sorting replaces the
hash-chain *data structure* (smallz4.h:515-519,603-744) with
sorted-neighborhood candidate discovery (ops/chunkmatch.py).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("n_keys", "unique"))
def sort_records(*planes, n_keys: int = 1, unique: bool = False):
    """Sort records lexicographically by the first ``n_keys`` planes
    (unsigned) with the next plane (pos) as tiebreak unless ``unique``
    (the last key plane is distinct across records, e.g. it embeds the
    position).  Returns the planes in the input order, sorted."""
    assert len(planes) >= n_keys + (0 if unique else 1)
    keyed = [p.view(jnp.uint32) if i < n_keys and p.dtype == jnp.int32 else p
             for i, p in enumerate(planes)]
    out = jax.lax.sort(keyed, num_keys=n_keys + (0 if unique else 1))
    return tuple(o.view(p.dtype) for o, p in zip(out, planes))
