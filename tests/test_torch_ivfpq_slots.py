"""The kernel backend's padded ivfpq scans map K1's selected slots to ids
without a candidate-id table (repro_torch.search.ivfpq).

K1's cell-major entry reads the probed cells in place beside their fills,
so the scans build no (Q, nprobe * max_cell) table ``lists[probe]``: slot
p * max_cell + r of query q is looked up as ``lists[probe[q, p], r]`` for
the k selected slots only. These tests hold that route against the table
route (the same scan handed the table ``probe_cells`` builds) bit for bit,
d2 and ids, on the CPU (K1's plain version) and, ``gpu``-marked, through
K1 on the card; and they fail if the kernel route builds the table.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes at once: one intra-op thread
# each keeps torch's many small CPU ops from contending for the cores
torch.set_num_threads(1)

from torch.overrides import TorchFunctionMode  # noqa: E402

from repro_torch.search import ivf as tivf  # noqa: E402
from repro_torch.search import ivfpq as tivfpq  # noqa: E402
from repro_torch.search.ivf import sq_dists  # noqa: E402
from repro_torch.search.knn import topk_smallest  # noqa: E402
from repro_torch.search.pq import adc_tables  # noqa: E402

N, D, NLIST, M, K = 1500, 16, 16, 4, 64
NQ, NPROBE, SHARDS = 7, 3, 3


def _corpus(seed, n, d=D, n_clusters=10):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)) * 4.0
    lab = rng.integers(0, n_clusters, n)
    return torch.from_numpy(
        (centers[lab] + rng.normal(size=(n, d))).astype(np.float32))


def _index(device="cpu", shards=1):
    gen = torch.Generator().manual_seed(11)
    return tivfpq.build_ivfpq(_corpus(1, N).to(device), NLIST, M, K,
                              kmeans_iters=4, pq_iters=3, device=device,
                              generator=gen, shards=shards)


def _live(device="cpu"):
    return (torch.from_numpy(np.random.default_rng(2).uniform(size=N) >= 0.3)
            .to(device))


def _args(ix, q):
    return (ix.codes_cell, ix.bias_cell, ix.lut_w, ix.cbnorm, ix.codebooks,
            q)


def _table_scan(ix, q, n_cand, lut_dtype, live):
    """The padded kernel scan as it ran with the table: ``probe_cells``'s
    candidate ids handed to the scan beside the cells' fills."""
    probe, cand, cd2p = tivf.probe_cells(ix.centroids, ix.lists, q, NPROBE,
                                         n_cand)
    cell_live = None if live is None else tivfpq.live_cells(ix.lists, live)
    return tivfpq.ivfpq_scan_given_probe(
        probe, cand, cd2p, *_args(ix, q), n_cand, backend="kernel",
        lut_dtype=lut_dtype, cell_len=(ix.lists >= 0).sum(dim=1),
        cell_live=cell_live)


def _table_local_scan(ix, q, n_cand, lut_dtype, live, shard, nl_loc):
    """The shard-local kernel scan as it ran with the table: the owned
    probes' posting ids, -1 for the slots of cells owned elsewhere."""
    sl = slice(shard * nl_loc, (shard + 1) * nl_loc)
    lists_loc = ix.lists[sl]
    cd2p, probe = topk_smallest(sq_dists(q, ix.centroids), NPROBE)
    lp = probe - shard * nl_loc
    own = (lp >= 0) & (lp < nl_loc)
    cand = torch.where(own[:, :, None], lists_loc[lp.clamp(0, nl_loc - 1)],
                       -1).reshape(q.shape[0], -1)
    cell_live = None if live is None else tivfpq.live_cells(lists_loc, live)
    return tivfpq.ivfpq_scan_given_probe(
        torch.where(own, lp, -1), cand, cd2p, ix.codes_cell[sl],
        ix.bias_cell[sl], ix.lut_w, ix.cbnorm, ix.codebooks, q, n_cand,
        backend="kernel", lut_dtype=lut_dtype,
        cell_len=(lists_loc >= 0).sum(dim=1), cell_live=cell_live)


def _local_scan(ix, q, n_cand, lut_dtype, live, shard, nl_loc):
    sl = slice(shard * nl_loc, (shard + 1) * nl_loc)
    return tivfpq.ivfpq_local_scan(
        ix.centroids, ix.lists[sl], ix.codes_cell[sl], ix.bias_cell[sl],
        ix.lut_w, ix.cbnorm, ix.codebooks, q, n_cand, NPROBE, shard,
        backend="kernel", lut_dtype=lut_dtype, live=live)


def _pairs(scan, ix, q, n_cand, lut_dtype, live):
    """(table-free result, table result) pairs of one scan: one pair, or
    one a rank for the shard-local scan."""
    if scan == "adc":
        got = tivfpq.ivfpq_adc_scan(ix.centroids, ix.lists, *_args(ix, q),
                                    n_cand, NPROBE, backend="kernel",
                                    lut_dtype=lut_dtype, live=live)
        return [(got, _table_scan(ix, q, n_cand, lut_dtype, live))]
    if scan == "given_probe":
        probe, cand, cd2p, cell_len = tivfpq.ivfpq_probe(
            ix.centroids, ix.lists, q, NPROBE, n_cand, "kernel")
        assert cand is None
        cell_live = None if live is None else tivfpq.live_cells(ix.lists,
                                                                live)
        got = tivfpq.ivfpq_scan_given_probe(
            probe, None, cd2p, *_args(ix, q), n_cand, backend="kernel",
            lut_dtype=lut_dtype, cell_len=cell_len, cell_live=cell_live,
            lists=ix.lists)
        return [(got, _table_scan(ix, q, n_cand, lut_dtype, live))]
    nl_loc = ix.lists.shape[0] // SHARDS
    return [(_local_scan(ix, q, n_cand, lut_dtype, live, s, nl_loc),
             _table_local_scan(ix, q, n_cand, lut_dtype, live, s, nl_loc))
            for s in range(SHARDS)]


def _n_cand(variant, ix):
    if variant == "degenerate":                   # more than P * max_cell
        return NPROBE * ix.lists.shape[1] + 9
    return 40


def _assert_bit_equal(got, want):
    (d, i), (dw, iw) = got, want
    assert d.shape == dw.shape and i.shape == iw.shape
    assert torch.equal(d.view(torch.int32), dw.view(torch.int32))
    assert torch.equal(i, iw)


SCANS = ("adc", "given_probe", "local")
VARIANTS = ("read_only", "live", "degenerate")


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("scan", SCANS)
@pytest.mark.parametrize("lut_dtype", ["f32", "int8"])
def test_table_free_route_matches_table_route(lut_dtype, scan, variant):
    """The kernel backend's scans without the candidate-id table return
    the table route's d2 and ids bit for bit: a read-only index, a live
    map with dead rows, a candidate budget past P * max_cell, and the
    shard-local scan on every rank (probes of cells owned elsewhere)."""
    ix = _index(shards=SHARDS if scan == "local" else 1)
    q = _corpus(5, NQ)
    live = _live() if variant == "live" else None
    n_cand = _n_cand(variant, ix)
    for got, want in _pairs(scan, ix, q, n_cand, lut_dtype, live):
        _assert_bit_equal(got, want)
        assert (got[1] >= 0).any()
        if variant == "degenerate":
            assert (got[1][:, -9:] == -1).all()
        if live is not None:
            hit = got[1][got[1] >= 0]
            assert live[hit].all()
    if scan == "local":
        # some queries probe cells of more than one rank
        owner = topk_smallest(sq_dists(q, ix.centroids), NPROBE)[1] // (
            ix.lists.shape[0] // SHARDS)
        assert (owner != owner[:, :1]).any()


def _entry_inputs(device, live_map, outside):
    """K1 cell-major entry inputs over the test index: the ADC tables,
    the probe (with ids -1 and past nlist when ``outside``), the table,
    the fills and a live map."""
    ix = _index(device)
    q = _corpus(9, NQ).to(device)
    probe, cand, cd2p = tivf.probe_cells(ix.centroids, ix.lists, q, NPROBE,
                                         1)
    nlist, max_cell = ix.lists.shape
    if outside:
        probe = probe.clone()
        probe[:, 1] = -1
        probe[::2, 2] = nlist + 2
        cand = cand.reshape(NQ, NPROBE, max_cell)
        cand[:, 1] = -1
        cand[::2, 2] = -1
        cand = cand.reshape(NQ, -1)
    tables = adc_tables(ix.lut_w, ix.cbnorm, q)
    live = (tivfpq.live_cells(ix.lists, _live(device)) if live_map
            else None)
    return ix, tables, probe, cand, cd2p, (ix.lists >= 0).sum(dim=1), live


def _entry_pair(device, lut_dtype, live_map, outside):
    from repro_torch.kernels.pq_adc import ops as adc_ops
    ix, tables, probe, cand, cd2p, fill, live = _entry_inputs(
        device, live_map, outside)
    args = (tables, probe, cd2p, ix.codes_cell, ix.bias_cell)
    got = adc_ops.pq_adc_cells_topk(*args, None, 24, lut_dtype,
                                    cell_len=fill, live=live)
    want = adc_ops.pq_adc_cells_topk(*args, cand, 24, lut_dtype,
                                     cell_len=fill, live=live)
    return got, want


@pytest.mark.parametrize("outside", [False, True])
@pytest.mark.parametrize("live_map", [False, True])
@pytest.mark.parametrize("lut_dtype", ["f32", "int8"])
def test_cells_entry_without_cand_matches_cand(lut_dtype, live_map,
                                               outside):
    """K1's cell-major entry (its plain version on the CPU) with
    ``cand=None`` beside the fills returns the slots and d2 of the call
    that passes the table, bit for bit; ``gather_cells`` derives the same
    base from the fills as from the table."""
    from repro_torch.kernels.pq_adc.ref import gather_cells
    _assert_bit_equal(*_entry_pair("cpu", lut_dtype, live_map, outside))
    ix, _, probe, cand, cd2p, fill, _ = _entry_inputs("cpu", False, outside)
    cc, base = gather_cells(probe, None, cd2p, ix.codes_cell, ix.bias_cell,
                            fill)
    ccw, basew = gather_cells(probe, cand, cd2p, ix.codes_cell,
                              ix.bias_cell)
    assert torch.equal(cc, ccw)
    assert torch.equal(base.view(torch.int32), basew.view(torch.int32))
    with pytest.raises(ValueError, match="cand or cell_len"):
        gather_cells(probe, None, cd2p, ix.codes_cell, ix.bias_cell)


@pytest.mark.gpu
@pytest.mark.parametrize("outside", [False, True])
@pytest.mark.parametrize("live_map", [False, True])
@pytest.mark.parametrize("lut_dtype", ["f32", "int8"])
def test_cuda_cells_entry_without_cand_matches_cand(lut_dtype, live_map,
                                                    outside):
    """On the card K1's cell-major entry with ``cand=None`` (slot range P
    * max_cell) returns what the call with the table returns, bit for
    bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    _assert_bit_equal(*_entry_pair("cuda", lut_dtype, live_map, outside))


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


class _ListsReads(TorchFunctionMode):
    """Records every op that reads the posting lists (a tensor on their
    storage, a rank's block of them too) and returns a tensor of at least
    ``numel`` elements: the size of a (Q, nprobe * max_cell) candidate-id
    table."""

    def __init__(self, lists, numel):
        super().__init__()
        self.ptr = lists.untyped_storage().data_ptr()
        self.numel, self.seen = numel, []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if isinstance(out, torch.Tensor) and out.numel() >= self.numel and \
                any(t.untyped_storage().data_ptr() == self.ptr
                    for t in _tensors((args, kwargs))):
            self.seen.append((getattr(func, "__name__", str(func)),
                              tuple(out.shape)))
        return out


def _raise(*args, **kwargs):
    raise AssertionError("the kernel route built the candidate-id table")


@pytest.mark.parametrize("scan", SCANS)
def test_kernel_route_builds_no_candidate_table(scan, monkeypatch):
    """The kernel backend's padded, given-probe and shard-local scans never
    call ``probe_cells`` and read the posting lists into no tensor of Q *
    nprobe * max_cell elements; the plain route, which gathers its
    candidates, still does (the check's control)."""
    ix = _index(shards=SHARDS if scan == "local" else 1)
    q = _corpus(6, NQ)
    table = NQ * NPROBE * ix.lists.shape[1]
    assert table > ix.lists.numel()
    with _ListsReads(ix.lists, table) as mode:
        tivfpq.ivfpq_adc_scan(ix.centroids, ix.lists, *_args(ix, q), 40,
                              NPROBE, backend="jnp", lut_dtype="int8")
    assert mode.seen
    monkeypatch.setattr(tivf, "probe_cells", _raise)
    monkeypatch.setattr(tivfpq, "probe_cells", _raise)
    for live in (None, _live()):
        with _ListsReads(ix.lists, table) as mode:
            if scan == "local":
                nl_loc = ix.lists.shape[0] // SHARDS
                for s in range(SHARDS):
                    _local_scan(ix, q, 40, "int8", live, s, nl_loc)
            elif scan == "adc":
                tivfpq.ivfpq_adc_scan(ix.centroids, ix.lists, *_args(ix, q),
                                      40, NPROBE, backend="kernel",
                                      lut_dtype="int8", live=live)
            else:
                probe, cand, cd2p, cell_len = tivfpq.ivfpq_probe(
                    ix.centroids, ix.lists, q, NPROBE, 40, "kernel")
                tivfpq.ivfpq_scan_given_probe(
                    probe, cand, cd2p, *_args(ix, q), 40, backend="kernel",
                    lut_dtype="int8", cell_len=cell_len, lists=ix.lists)
        assert mode.seen == []


def test_deep_trace_and_engine_build_no_candidate_table(monkeypatch):
    """A kernel-backend engine's padded search and ``deep_trace``'s ivfpq
    decomposition run with ``probe_cells`` unavailable."""
    from repro_torch.search import build_engine, deep_trace
    eng = build_engine(_corpus(1, 600, 32).numpy(),
                       "ivf12x4>pq8x64:i8@kernel>rr40", device="cpu")
    q = _corpus(7, 96, 32)
    ref = eng.search(q, 10)
    monkeypatch.setattr(tivf, "probe_cells", _raise)
    monkeypatch.setattr(tivfpq, "probe_cells", _raise)
    got = eng.search(q, 10)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    kw = dict(nprobe=eng.config.nprobe, rerank=eng.config.rerank,
              backend="kernel", lut_dtype=eng.config.lut_dtype, scan_cap=0,
              prefilter=0)
    out = deep_trace(eng, q, 10, kw)
    assert [s for s, _ in out["stages"]] == ["project", "probe", "scan",
                                             "rerank"]


def test_scan_given_probe_without_table_needs_the_fills_and_lists():
    """``cand=None`` is the kernel backend's route beside ``cell_len``:
    the plain backend, or a call without the fills or the lists to map
    the slots, is refused."""
    ix = _index()
    q = _corpus(8, NQ)
    probe, _, cd2p, cell_len = tivfpq.ivfpq_probe(ix.centroids, ix.lists, q,
                                                  NPROBE, 40, "kernel")
    for kw in (dict(backend="jnp", cell_len=cell_len, lists=ix.lists),
               dict(backend="kernel", lists=ix.lists),
               dict(backend="kernel", cell_len=cell_len)):
        with pytest.raises(ValueError, match="cand=None"):
            tivfpq.ivfpq_scan_given_probe(probe, None, cd2p, *_args(ix, q),
                                          40, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("scan", SCANS)
@pytest.mark.parametrize("lut_dtype", ["f32", "int8"])
def test_cuda_table_free_route_matches_table_route(lut_dtype, scan, variant):
    """Through K1 on the card: the scans without the candidate-id table
    return the table route's d2 and ids bit for bit (both launch K1's
    cell-major entry on the fills, one launch a scan a rank)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.kernels.pq_adc import ops as adc_ops
    ix = _index("cuda", shards=SHARDS if scan == "local" else 1)
    q = _corpus(5, NQ).cuda()
    live = _live("cuda") if variant == "live" else None
    n_cand = _n_cand(variant, ix)
    c0 = adc_ops.pq_adc_cells_topk.launches
    pairs = _pairs(scan, ix, q, n_cand, lut_dtype, live)
    torch.cuda.synchronize()
    assert adc_ops.pq_adc_cells_topk.launches - c0 == 2 * len(pairs)
    for got, want in pairs:
        _assert_bit_equal(got, want)
        assert (got[1] >= 0).any()
