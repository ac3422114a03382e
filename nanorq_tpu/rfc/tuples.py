"""RFC 6330 s5.3.5.4 tuple generator and LT/PI neighbor index expansion.

Parity: reference lib/tuple.c (deg, gen_tuple) and lib/params.c:47-65
(params_set_idxs).  Everything is vectorized over the symbol id X (= ISI) so
a whole block's worth of symbols expands with a few NumPy gathers; the padded
[n, MAX_NEIGHBORS] index matrix these produce is exactly what the batched device
LT combine consumes.
"""

from typing import NamedTuple

import numpy as np

from nanorq_tpu.rfc.params import Params
from nanorq_tpu.rfc.rand import rnd_get
from nanorq_tpu.rfc.tables import DEGREE_DIST

# d <= 30 (degree distribution) and d1 <= 3, so 33 neighbor slots suffice.
MAX_NEIGHBORS = 33


class Tuples(NamedTuple):
    """Per-symbol tuples (d, a, b, d1, a1, b1); each field is uint32 [n]."""

    d: np.ndarray
    a: np.ndarray
    b: np.ndarray
    d1: np.ndarray
    a1: np.ndarray
    b1: np.ndarray


def gen_tuples(X, P: Params) -> Tuples:
    """Tuple[K', X] for an array of ISIs X (RFC 6330 s5.3.5.4)."""
    X = np.atleast_1d(np.asarray(X, dtype=np.uint32))
    A = 53591 + P.J * 997
    if A % 2 == 0:
        A += 1
    B1 = 10267 * (P.J + 1)
    y = (np.uint32(B1) + X * np.uint32(A)).astype(np.uint32)
    v = rnd_get(y, 0, 1 << 20)
    # smallest d with v < DEGREE_DIST[d], capped at W-2 (lib/tuple.c:13-19)
    d = np.searchsorted(DEGREE_DIST, v, side="right").astype(np.uint32)
    d = np.minimum(d, np.uint32(P.W - 2))
    a = 1 + rnd_get(y, 1, P.W - 1)
    b = rnd_get(y, 2, P.W)
    d1 = np.where(d < 4, 2 + rnd_get(X, 3, 2), np.uint32(2)).astype(np.uint32)
    a1 = 1 + rnd_get(X, 4, P.P1 - 1)
    b1 = rnd_get(X, 5, P.P1)
    return Tuples(d, a, b, d1, a1, b1)


def lt_indices(X, P: Params) -> tuple[np.ndarray, np.ndarray]:
    """Expand ISIs X into intermediate-symbol column indices of the LT rows.

    Returns (idx, valid): idx is int32 [n, MAX_NEIGHBORS] with LT neighbors
    (b + j*a) % W followed by PI neighbors W + b1_j; `valid` is the bool mask
    of live slots (row X of the precode matrix has ones exactly at
    idx[valid]).  Padding slots hold 0 and must be masked by the caller.

    Parity: reference lib/params.c:47-65.
    """
    t = gen_tuples(X, P)
    n = t.d.shape[0]
    max_d = min(30, P.W - 2)

    # LT part: b, b+a, ..., b+(d-1)a mod W.  W is prime so entries are unique.
    j = np.arange(max(max_d, 1), dtype=np.uint64)
    lt = (t.b.astype(np.uint64)[:, None] + j[None, :] * t.a.astype(np.uint64)[:, None]) % np.uint64(P.W)
    lt_valid = j[None, :] < t.d[:, None]

    # PI part: walk the a1-progression mod P1, keeping values < P, first d1.
    # Within one period the progression visits P1 distinct values of which
    # P1 - P are skipped, so d1_max + (P1 - P) steps always suffice.
    steps = 3 + (P.P1 - P.P)
    s = np.arange(steps, dtype=np.uint64)
    seq = (t.b1.astype(np.uint64)[:, None] + s[None, :] * t.a1.astype(np.uint64)[:, None]) % np.uint64(P.P1)
    keep = seq < P.P
    # rank of each kept value within its row
    rank = np.cumsum(keep, axis=1) - 1
    pi_valid = keep & (rank < t.d1[:, None])
    # scatter kept values into [n, 3] by rank
    pi = np.zeros((n, 3), dtype=np.uint64)
    rows, cols = np.nonzero(pi_valid)
    pi[rows, rank[rows, cols]] = seq[rows, cols]
    pi_mask = np.arange(3)[None, :] < t.d1[:, None]

    idx = np.zeros((n, MAX_NEIGHBORS), dtype=np.int32)
    valid = np.zeros((n, MAX_NEIGHBORS), dtype=bool)
    idx[:, :lt.shape[1]] = lt.astype(np.int32)
    valid[:, :lt.shape[1]] = lt_valid
    idx[:, 30:33] = (pi + np.uint64(P.W)).astype(np.int32)
    valid[:, 30:33] = pi_mask
    idx[~valid] = 0
    return idx, valid
