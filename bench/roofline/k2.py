"""Kernel K2's work (``kernels/pq_adc`` ``pq_adc_topk``): ADC scoring of
every code row for every query and a top-k per query.

Every (query, row) pair costs M table adds and one rescale (M + 1
operations); the bytes are the code matrix read once, the f32 tables in
and the (distance, row) pairs out.
"""


def count(call: dict):
    """``call``: ``tables`` (Q, M, K), ``codes`` (N, M), ``k``. Returns
    (operations, bytes)."""
    nq, m, kc = call["tables"].shape
    codes = call["codes"]
    n = codes.shape[0]
    nbytes = n * m * codes.element_size() + nq * m * kc * 4 + nq * call["k"] * 8
    return nq * n * (m + 1), nbytes
