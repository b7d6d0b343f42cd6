"""Kernel K1's work, cell-major entry (``kernels/pq_adc``
``pq_adc_cells_topk``): ADC scoring of the probed cells' posting rows and
a top-k per query.

Counted from the call's own inputs, the work these inputs need and not
the implementation's: every (query, probed row) is a candidate at M table
adds, one rescale and one compare (M + 2 operations); the bytes are the
filled rows of the distinct probed cells read once (M code bytes and a
4-byte bias each, plus a byte of the live map where the call passes one),
the probe list with its coarse distances, the cells' fills, the f32
tables in and the (distance, slot) pairs out.
"""
import torch


def count(call: dict):
    """``call``: ``tables`` (Q, M, K), ``probe`` (Q, P), ``cell_len``
    (nlist,), ``codes_cell`` (nlist, cap, M), ``k``, and ``live`` (a map or
    None). Returns (operations, bytes)."""
    nq, m, kc = call["tables"].shape
    probe, cell_len = call["probe"], call["cell_len"].to(torch.int64)
    code_bytes = call["codes_cell"].element_size()
    row = m * code_bytes + 4 + (1 if call.get("live") is not None else 0)
    used = cell_len[torch.unique(probe)]
    scored = int(cell_len[probe].sum())                 # Q * filled slots
    nbytes = (int(used.sum()) * row + probe.numel() * 12
              + cell_len.numel() * 8 + nq * m * kc * 4 + nq * 4
              + nq * call["k"] * 8)
    return scored * (m + 2), nbytes
