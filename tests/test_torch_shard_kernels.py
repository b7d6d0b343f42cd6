"""The kernel routes of sharded serving: K1's cell-major entry with probed
cell ids outside [0, nlist) (the shard-local ivfpq scan passes -1 for a
cell another rank owns) and K2's global entry ``pq_adc_topk_global``.

On the CPU: the cell-major entry's plain version treats an out-of-range
probe as an empty cell on the ``cand``, ``cell_len`` and ``live`` routes
(before the repair a -1 probe wrapped to the last cell, and the test
shows that reading differs from the contract); ``pq_adc_topk_global``'s
plain version against the contract built from the shared-codes scores
and against JAX's (Pallas interpret mode). On the card (``gpu``, skipped
here): each kernel against its plain version on the same CUDA inputs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels.pq_adc import ops  # noqa: E402
from repro_torch.kernels.pq_adc.ref import pq_adc_scores_ref  # noqa: E402
from repro_torch.search.ivfpq import live_cells  # noqa: E402
from repro_torch.search.knn import topk_smallest  # noqa: E402

ROUTES = ("cand", "cell_len", "live")


def _cells(seed, nq=6, nlist=20, top=30, nprobe=5, m=8, kc=64):
    """Left-packed cells, probes with some ids -1 or >= nlist (cells owned
    by another rank), the probed slots' ids as the caller would pass them
    with the out-of-range probes' slots not masked (wrapped like Python
    indexing), a live map, and tables; numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, top + 1, nlist)
    max_cell = int(sizes.max())
    lists = np.full((nlist, max_cell), -1, np.int64)
    start = 0
    for c, n in enumerate(sizes):
        lists[c, :n] = np.arange(start, start + n)
        start += n
    codes_cell = rng.integers(0, kc, (nlist, max_cell, m)).astype(np.uint8)
    bias_cell = np.where(lists >= 0, rng.uniform(-1, 1, lists.shape),
                         0.0).astype(np.float32)
    probe = np.stack([rng.choice(nlist, nprobe, replace=False)
                      for _ in range(nq)]).astype(np.int64)
    probe[:, 1] = -1                       # another rank's cell
    probe[::2, 3] = nlist + 2              # past the block
    cd2p = rng.uniform(0, 2, (nq, nprobe)).astype(np.float32)
    cand = lists[probe % nlist].reshape(nq, -1)
    live = (rng.uniform(size=lists.shape) > 0.2).astype(np.uint8)
    tables = (rng.uniform(size=(nq, m, kc)) * 4).astype(np.float32)
    return tables, probe, cd2p, codes_cell, bias_cell, cand, lists, live


def _contract(tables, probe, cd2p, codes_cell, bias_cell, lists, live, k):
    """The kernel's contract in numpy terms: slots of a probed id outside
    [0, nlist) score nothing; the others ADC-score their cell's row."""
    nq, nprobe = probe.shape
    nlist, max_cell, m = codes_cell.shape
    inside = (probe >= 0) & (probe < nlist)
    cell = np.where(inside, probe, 0)
    ok = inside[:, :, None] & (lists[cell] >= 0)
    if live is not None:
        ok &= live[cell] != 0
    base = np.where(ok, cd2p[:, :, None] + bias_cell[cell], np.inf)
    ccodes = codes_cell[cell].reshape(nq, -1, m)
    return ops.pq_adc_gather_topk_plain(
        torch.from_numpy(tables), torch.from_numpy(ccodes),
        torch.from_numpy(base.reshape(nq, -1).astype(np.float32)), k)


@pytest.mark.parametrize("route", ROUTES)
def test_plain_cells_route_reads_nothing_for_out_of_range_probes(route):
    tables, probe, cd2p, cc, bc, cand, lists, live = _cells(3)
    k = 16
    args = [torch.from_numpy(a) for a in (tables, probe, cd2p, cc, bc, cand)]
    kw = {}
    if route != "cand":
        kw["cell_len"] = torch.from_numpy((lists >= 0).sum(axis=1))
    if route == "live":
        kw["live"] = torch.from_numpy(live)
    d, i = ops.pq_adc_cells_topk(*args, k, **kw)
    dw, iw = _contract(tables, probe, cd2p, cc, bc, lists,
                       live if route == "live" else None, k)
    assert torch.equal(d, dw) and torch.equal(i, iw)
    # before the repair a -1 probe read the last cell (Python indexing)
    # and a probe past nlist raised: the wrapped reading differs
    wrapped = np.where(probe >= cc.shape[0], -1, probe)
    dold, iold = _contract(tables, wrapped % cc.shape[0], cd2p, cc, bc,
                           lists, live if route == "live" else None, k)
    assert not torch.equal(iold, iw)


def test_live_slots_and_gather_mask_out_of_range_probes():
    from repro_torch.kernels.pq_adc.ref import gather_cells, live_slots
    tables, probe, cd2p, cc, bc, cand, lists, live = _cells(5)
    t = [torch.from_numpy(a) for a in (probe, cand, cd2p, cc, bc)]
    _, base = gather_cells(*t)
    outside = ~((t[0] >= 0) & (t[0] < cc.shape[0]))
    mc = cc.shape[1]
    assert torch.isinf(base[outside.repeat_interleave(mc, dim=1)]).all()
    ok = live_slots(t[0], torch.from_numpy(live), cand.shape[1])
    assert not ok[outside.repeat_interleave(mc, dim=1)].any()
    assert live_cells(torch.from_numpy(lists), torch.ones(
        int(lists.max()) + 1, dtype=torch.bool)).dtype == torch.uint8


def _global_inputs(seed, nq=5, n_loc=75, m=8, kc=64):
    rng = np.random.default_rng(seed)
    tables = (rng.uniform(size=(nq, m, kc)) * 4).astype(np.float32)
    codes = rng.integers(0, kc, (n_loc, m)).astype(np.uint8)
    return tables, codes


@pytest.mark.parametrize("lut_dtype", ["f32", "int8"])
@pytest.mark.parametrize("slack", [0, 1, 7])
def test_pq_adc_topk_global_plain_contract(slack, lut_dtype):
    """The plain version: the block's rows past ``n_valid`` never appear,
    ids are global, and the result is the top k of the valid rows' shared
    scores (ties to the lower row), (+inf, -1) padded."""
    tables, codes = _global_inputs(slack)
    off, k = 150, 12
    n_valid = off + codes.shape[0] - slack      # the block's tail is padding
    tt, tc = torch.from_numpy(tables), torch.from_numpy(codes)
    d, g = ops.pq_adc_topk_global(tt, tc, k, row_offset=off, n_valid=n_valid,
                                  slack=slack, lut_dtype=lut_dtype)
    scores = pq_adc_scores_ref(tt, tc, lut_dtype)
    rows = codes.shape[0] - slack
    dw, iw = topk_smallest(scores[:, :rows], k)
    assert torch.equal(g, iw + off)
    assert torch.equal(d, dw)
    assert (g < n_valid).all()
    dp, gp = ops.pq_adc_topk_global(tt, tc[:5], k, row_offset=0, n_valid=3,
                                    slack=slack, lut_dtype=lut_dtype)
    # a block shorter than k + slack: no re-take, the pads stay in place
    assert ((gp == -1).sum(dim=1) == k - 3).all() and (gp < 3).all()
    assert torch.equal(torch.isinf(dp), gp == -1)


@pytest.mark.parametrize("slack,lut_dtype", [(1, "f32"), (7, "int8")])
def test_pq_adc_topk_global_plain_matches_jax(slack, lut_dtype):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.pq_adc.ops import pq_adc_topk_global as jax_global
    tables, codes = _global_inputs(10 + slack)
    off, k = 300, 12
    n_valid = off + codes.shape[0] - slack
    d, g = ops.pq_adc_topk_global_plain(torch.from_numpy(tables),
                                        torch.from_numpy(codes), k, off,
                                        n_valid, slack, lut_dtype)
    dj, gj = jax_global(jnp.asarray(tables), jnp.asarray(codes), k,
                        row_offset=jnp.asarray(off, jnp.int32),
                        n_valid=jnp.asarray(n_valid, jnp.int32), slack=slack,
                        interpret=True, lut_dtype=lut_dtype)
    np.testing.assert_array_equal(g.numpy(), np.asarray(gj))
    np.testing.assert_allclose(d.numpy(), np.asarray(dj), rtol=1e-6)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("lut_dtype", ["f32", "int8"])
def test_cuda_cells_entry_skips_out_of_range_probes(lut_dtype, route):
    """K1's cell-major entry on the card with probes of -1 and past nlist:
    the kernel's result equals its plain version's on the same CUDA
    inputs (ids equal; int8 d2 bit-equal, f32 within rtol 1e-6)."""
    dev = _cuda()
    tables, probe, cd2p, cc, bc, cand, lists, live = _cells(7, nq=9)
    args = [torch.from_numpy(a).to(dev)
            for a in (tables, probe, cd2p, cc, bc, cand)]
    kw = {}
    if route != "cand":
        kw["cell_len"] = torch.from_numpy((lists >= 0).sum(axis=1)).to(dev)
    if route == "live":
        kw["live"] = torch.from_numpy(live).to(dev)
    before = ops.pq_adc_cells_topk.launches
    d, i = ops.pq_adc_cells_topk(*args, 16, lut_dtype, **kw)
    assert ops.pq_adc_cells_topk.launches == before + 1
    dp, ip = ops.pq_adc_cells_topk_plain(*args, 16, lut_dtype,
                                         live=kw.get("live"))
    assert torch.equal(i, ip)
    if lut_dtype == "int8":
        assert torch.equal(d, dp)
    else:
        torch.testing.assert_close(d, dp, rtol=1e-6, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("lut_dtype", ["f32", "int8"])
@pytest.mark.parametrize("slack", [0, 1, 7])
def test_cuda_pq_adc_topk_global_matches_plain(slack, lut_dtype):
    """K2's global entry on the card against its plain version: global
    ids equal, d2 within rtol 1e-6 (int8 bit-equal); one K2 launch a
    call, counted on both wrappers."""
    dev = _cuda()
    tables, codes = _global_inputs(20 + slack, nq=9, n_loc=5003)
    off, k = 5003, 64
    n_valid = off + codes.shape[0] - slack
    tt, tc = torch.from_numpy(tables).to(dev), torch.from_numpy(codes).to(dev)
    b2, bg = ops.pq_adc_topk.launches, ops.pq_adc_topk_global.launches
    d, g = ops.pq_adc_topk_global(tt, tc, k, row_offset=off, n_valid=n_valid,
                                  slack=slack, lut_dtype=lut_dtype)
    assert ops.pq_adc_topk.launches == b2 + 1
    assert ops.pq_adc_topk_global.launches == bg + 1
    dp, gp = ops.pq_adc_topk_global_plain(tt, tc, k, off, n_valid, slack,
                                          lut_dtype)
    assert torch.equal(g, gp)
    if lut_dtype == "int8":
        assert torch.equal(d, dp)
    else:
        torch.testing.assert_close(d, dp, rtol=1e-6, atol=0)
