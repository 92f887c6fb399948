"""Row gathers for small tables.

For tables of <= ONEHOT_MAX_ROWS rows a lookup is a one-hot (R, T) matrix
contracted with the (T, C) table at HIGHEST precision (an exact row
select); larger tables use a single packed-row gather (one gather instead
of a dozen).  Whether the one-hot form still pays on the GPU against a
plain gather is not measured yet.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

ONEHOT_MAX_ROWS = 2048


def onehot_gather(table, idx):
    """table (T, C) f32, idx (R,) int -> (R, C).

    Exact: the one-hot has exactly one 1.0 per row, so the f32 product at
    HIGHEST precision is a row select.
    """
    T = table.shape[0]
    if T > ONEHOT_MAX_ROWS:
        return table[jnp.clip(idx, 0, T - 1)]
    cols = jax.lax.broadcasted_iota(jnp.int32, (idx.shape[0], T), 1)
    onehot = (cols == idx[:, None]).astype(jnp.float32)
    # one-hot row select; HIGHEST keeps the f32 rows exact (a reduced
    # precision such as TF32 or bf16 would round them)
    return jax.lax.dot_general(
        onehot, table,
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )


def pack_rows(*arrays):
    """Concatenate per-row fields into a (N, C) matrix for row-select.

    1-D arrays become single columns (ints cast to f32 — exact < 2^24).
    Built from the LIVE pytree fields each trace, so parameter gradients
    flow and there is no stale-copy hazard; XLA hoists the concat out of
    the bounce scan.
    """
    cols = []
    for a in arrays:
        if a.ndim == 1:
            a = a[:, None]
        cols.append(a.astype(jnp.float32))
    return jnp.concatenate(cols, axis=1)
