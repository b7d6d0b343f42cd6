"""Kernel K3's work (``kernels/knn_topk`` ``knn_topk_d2``): exact squared
L2 distances of every query to every database row and a top-k per query.

Counted from the call's shape, the work it needs and not the
implementation's: every (query, row) pair costs D multiplies and D adds
(2·Q·N·D operations; the norms and the compare against the k-th are left
out, as they are a small share at D 64); the bytes are the f32 rows and
their norms read once, the queries in and the (distance, row) pairs out.
"""


def count(call: dict):
    """``call``: ``queries`` Q, ``rows`` N, ``dim`` D, ``k``. Returns
    (operations, bytes)."""
    nq, n, d, k = (int(call[key]) for key in ("queries", "rows", "dim", "k"))
    nbytes = n * d * 4 + n * 4 + nq * d * 4 + nq * k * 8
    return 2 * nq * n * d, nbytes
