"""GIN in the port (repro_torch.models.gnn on kernels.graph_agg) against
repro.models.gnn, the parameters carried across by
bridge.gin_params_from_arrays: the aggregate's plain version and
gin_aggregate's forward and backward bit-equal to JAX's segment_sum of
the masked messages and its jax.grad; the three regimes' forwards,
losses and gradients; build_csr's orders; twins of
tests/test_models_other.py's GIN tests. The gpu cases hold the CUDA
kernel against its plain version and skip without a card."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch import bridge  # noqa: E402
from repro_torch._tree import keyed_leaves, tree_map  # noqa: E402
from repro_torch.data import make_random_graph  # noqa: E402
from repro_torch.data import sample_neighborhood_batch  # noqa: E402
from repro_torch.kernels import graph_agg  # noqa: E402
from repro_torch.kernels.graph_agg import (build_csr,  # noqa: E402
                                           csr_gather_sum,
                                           csr_gather_sum_plain,
                                           gather_sum_ref, gin_aggregate)
from repro_torch.models import gnn  # noqa: E402
from repro_torch.optim import value_and_grad  # noqa: E402

# the issue's small size: N 64, E 300 of which the last 20 are masked
# padding, F 12, hidden 16, 3 layers, fanout (3, 2), G 5 molecules of 6
N, E, PAD, F, HIDDEN, LAYERS, CLASSES = 64, 300, 20, 12, 16, 3, 5
FANOUT, B, G, NMOL = (3, 2), 6, 5, 6
# forwards: the same f32 operations, the MLP matmuls blocked differently
# by XLA and by torch (the aggregate itself is bit-equal); the atol is
# 1e-6 of the output's largest entry, since an entry near 0 is a sum of
# terms of that size (logits up to ~17 here: a ulp is 1.9e-6, and one
# entry of 1.7e-3 differs by 3.7e-6)
FWD_RTOL, FWD_ATOL = 1e-5, 1e-6
# losses and gradients (through 3 layers of those matmuls and back)
GRAD_RTOL = 1e-4


def _jax():
    """JAX is imported by the parity tests only: the machine with the card
    has no JAX, and runs this file's gpu tests alone
    (``pytest --noconftest -m gpu``)."""
    jax = pytest.importorskip("jax")
    from repro.models import gnn as jgnn
    return jax, jax.numpy, jgnn


def _arrays(jax, tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf
            in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _graph(seed=0, n=N, e=E, pad=PAD, f=F):
    """make_random_graph's power-law graph with ``pad`` masked edges at
    the end (sources and destinations drawn, mask 0), labels in
    [0, CLASSES)."""
    feats, src, dst, labels = make_random_graph(seed, n, e - pad, f,
                                                CLASSES)
    rng = np.random.default_rng(seed + 100)
    src = np.concatenate([src, rng.integers(0, n, pad).astype(np.int32)])
    dst = np.concatenate([dst, rng.integers(0, n, pad).astype(np.int32)])
    mask = np.concatenate([np.ones(e - pad, np.float32),
                           np.zeros(pad, np.float32)])
    return feats, src, dst, mask, labels


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def model():
    """(JAX cfg, JAX params, port cfg, port params) at the small size."""
    jax, _, jgnn = _jax()
    kw = dict(name="g", n_layers=LAYERS, d_hidden=HIDDEN, d_feat=F,
              n_classes=CLASSES, fanout=FANOUT)
    jcfg, tcfg = jgnn.GINConfig(**kw), gnn.GINConfig(**kw)
    jp = jgnn.gin_init_params(jax.random.key(0), jcfg)
    # eps 0 at init: give each layer its own, so (1 + eps) is exercised
    jp["layers"] = [dict(lp, eps=jax.numpy.float32(0.1 * (i + 1)))
                    for i, lp in enumerate(jp["layers"])]
    tp = bridge.gin_params_from_arrays(_arrays(jax, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


# ------------------------------------------------------- the aggregate

@pytest.mark.parametrize("case", ["masked", "no_mask", "non_finite"])
def test_aggregate_bit_equal_to_jax_segment_sum(case):
    """The plain version, the CSR plain version and gin_aggregate forward
    equal JAX's segment_sum(h[src] * mask, dst) bit for bit, and the
    backward JAX's jax.grad through h[src]; a non-finite feature on a
    masked edge gives NaN in both (the multiply by the mask is kept)."""
    jax, jnp, _ = _jax()
    feats, src, dst, mask, _ = _graph(seed=1)
    if case == "non_finite":
        feats[src[-1]] = np.inf                  # read by a masked edge
    jmask = None if case == "no_mask" else mask
    rng = np.random.default_rng(2)
    ct = rng.standard_normal((N, F)).astype(np.float32)

    def agg(h):
        msg = h[src]
        if jmask is not None:
            msg = msg * jnp.asarray(jmask)[:, None]
        return jax.ops.segment_sum(msg, dst, num_segments=N)

    want = np.asarray(agg(jnp.asarray(feats)))
    want_g = np.asarray(jax.grad(lambda h: jnp.sum(agg(h) * ct))(
        jnp.asarray(feats)))
    tm = None if jmask is None else _t(jmask)
    csr = build_csr(_t(src), _t(dst), tm, N)
    h = _t(feats).requires_grad_()
    got = gin_aggregate(h, csr)
    (got_g,) = torch.autograd.grad(got, h, _t(ct))
    ones = np.ones(E, np.float32)
    plain = gather_sum_ref(_t(feats), _t(src), _t(dst),
                           _t(ones if jmask is None else jmask), N)
    for t in (got.detach(), plain, csr_gather_sum_plain(_t(feats), csr.fwd),
              csr_gather_sum(_t(feats), csr.fwd)):
        np.testing.assert_array_equal(t.numpy(), want)
    np.testing.assert_array_equal(got_g.numpy(), want_g)
    np.testing.assert_array_equal(
        csr_gather_sum_plain(_t(ct), csr.bwd).numpy(), want_g)
    if case == "non_finite":
        assert np.isnan(want).any() and np.isnan(got.detach().numpy()).any()


def test_build_csr_orders_are_stable():
    """Each order is a stable sort by its row endpoint (a row keeps its
    edges in edge order), rowptr counts them, rows lists the rows by
    descending degree (ties by row id), and empty rows have no edges."""
    src = torch.tensor([3, 0, 3, 1, 0, 3])
    dst = torch.tensor([1, 1, 0, 1, 4, 0])
    mask = torch.tensor([1.0, 0.0, 1.0, 1.0, 0.5, 1.0])
    csr = build_csr(src, dst, mask, 5, n_src=4)
    f, b = csr.fwd, csr.bwd
    assert (f.by, b.by) == ("dst", "src")
    assert f.rowptr.tolist() == [0, 2, 5, 5, 5, 6]         # rows 2, 3 empty
    assert f.col.tolist() == [3, 3, 3, 0, 1, 0]            # edges 2,5 | 0,1,3 | 4
    assert f.w.tolist() == [1.0, 1.0, 1.0, 0.0, 1.0, 0.5]
    assert f.rows.tolist() == [1, 0, 4, 2, 3]
    assert b.rowptr.tolist() == [0, 2, 3, 3, 6]            # source 2 empty
    assert b.col.tolist() == [1, 4, 1, 1, 0, 0]            # edges 1,4 | 3 | 0,2,5
    assert b.rows.tolist() == [3, 0, 1, 2]
    for t in (f.rowptr, f.col, f.rows, b.rowptr, b.col, b.rows):
        assert t.dtype == torch.int32
    assert f.w.dtype == torch.float32
    with pytest.raises(ValueError, match="out of range"):
        build_csr(src, dst, mask, 4)
    with pytest.raises(ValueError):
        build_csr(src, dst[:3], None, 5)


def test_one_source_with_every_edge_and_empty_rows():
    """Every edge leaves source 0 (the backward's one long row; every
    other source empty) and half the nodes receive none: the forward's
    empty rows are 0, the backward adds all E edges into row 0 in edge
    order, both equal to the edge-list plain version."""
    rng = np.random.default_rng(5)
    n, e, f = 40, 500, 7
    src = np.zeros(e, np.int32)
    dst = rng.integers(0, n // 2, e).astype(np.int32)
    mask = (rng.random(e) > 0.2).astype(np.float32)
    h = rng.standard_normal((n, f)).astype(np.float32)
    ct = rng.standard_normal((n, f)).astype(np.float32)
    csr = build_csr(_t(src), _t(dst), _t(mask), n)
    assert int(csr.bwd.rowptr[1]) == e and int(csr.bwd.rows[0]) == 0
    th = _t(h).requires_grad_()
    out = gin_aggregate(th, csr)
    (g,) = torch.autograd.grad(out, th, _t(ct))
    assert torch.equal(out[n // 2:], torch.zeros(n - n // 2, f))
    assert torch.equal(out.detach(), gather_sum_ref(_t(h), _t(src), _t(dst),
                                                    _t(mask), n))
    assert torch.equal(g, gather_sum_ref(_t(ct), _t(dst), _t(src),
                                         _t(mask), n))
    assert torch.equal(g[1:], torch.zeros(n - 1, f))
    assert torch.equal(g, csr_gather_sum_plain(_t(ct), csr.bwd))


def test_aggregate_checks_its_inputs():
    csr = build_csr(torch.tensor([0, 1]), torch.tensor([1, 0]), None, 2)
    with pytest.raises(ValueError, match="rows"):
        gin_aggregate(torch.zeros(3, 4), csr)
    with pytest.raises(ValueError):
        csr_gather_sum(torch.zeros(4), csr.fwd)


# ------------------------------------------------- the three regimes

def _full_batch(seed=3):
    feats, src, dst, mask, labels = _graph(seed=seed)
    label_mask = (np.random.default_rng(seed).random(N) > 0.3).astype(
        np.float32)
    return {"feats": feats, "edge_src": src, "edge_dst": dst,
            "edge_mask": mask, "labels": labels, "label_mask": label_mask}


def _sampled_batch(seed=4):
    feats, src, dst, labels = make_random_graph(seed, N, E, F, CLASSES)
    return sample_neighborhood_batch(seed + 1, feats, src, dst, labels, B,
                                     FANOUT)


def _mol_batch(seed=5):
    rng = np.random.default_rng(seed)
    a = (rng.random((G, NMOL, NMOL)) > 0.6).astype(np.float32)
    adj = np.maximum(a, a.transpose(0, 2, 1))             # symmetric 0/1
    return {"feats": rng.standard_normal((G, NMOL, F)).astype(np.float32),
            "adj": adj, "labels": rng.integers(0, CLASSES, G).astype(
                np.int32)}


_BATCHES = {"full": _full_batch, "sampled": _sampled_batch,
            "mol": _mol_batch}


def _forward(mod, regime, p, cfg, b, as_array):
    if regime == "full":
        return mod.gin_full_forward(p, cfg, *(as_array(b[k]) for k in (
            "feats", "edge_src", "edge_dst", "edge_mask")))
    if regime == "sampled":
        return mod.gin_sampled_forward(p, cfg, [
            as_array(b[f"feat_l{d}"]) for d in range(len(FANOUT) + 1)])
    return mod.gin_mol_forward(p, cfg, as_array(b["feats"]),
                               as_array(b["adj"]))


_LOSSES = {"full": "gin_full_loss", "sampled": "gin_sampled_loss",
           "mol": "gin_mol_loss"}


@pytest.mark.parametrize("regime", ["full", "sampled", "mol"])
def test_forward_matches_jax(model, regime):
    jax, jnp, jgnn = _jax()
    jcfg, jp, tcfg, tp = model
    b = _BATCHES[regime]()
    want = np.asarray(_forward(jgnn, regime, jp, jcfg, b, jnp.asarray))
    with torch.no_grad():
        got = _forward(gnn, regime, tp, tcfg, b, _t)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=FWD_RTOL,
                               atol=FWD_ATOL * float(np.abs(want).max()))


@pytest.mark.parametrize("regime", ["full", "sampled", "mol"])
def test_loss_and_grads_match_jax(model, regime):
    """Each loss and every gradient leaf (the MLPs, each eps, the head)
    against jax.value_and_grad, at rtol 1e-4 (and an atol of 1e-4 of the
    leaf's largest entry, for entries near 0)."""
    jax, jnp, jgnn = _jax()
    jcfg, jp, tcfg, tp = model
    b = _BATCHES[regime]()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jfn = getattr(jgnn, _LOSSES[regime])
    jl, jg = jax.value_and_grad(lambda p: jfn(p, jcfg, jb))(jp)
    want = _arrays(jax, jg)
    tb = {k: _t(v) for k, v in b.items()}
    tfn = getattr(gnn, _LOSSES[regime])
    tl, tg = value_and_grad(lambda p, bb: tfn(p, tcfg, bb),
                            tree_map(lambda t: t.detach().clone(), tp), tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=GRAD_RTOL)
    got = dict(keyed_leaves(tg))
    assert sorted(got) == sorted(want)
    for key, g in got.items():
        scale = float(np.abs(want[key]).max())
        np.testing.assert_allclose(g.numpy(), want[key], rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * scale, err_msg=key)
    if regime == "full":
        assert float(np.abs(want["['layers'][0]['eps']"])) > 0


def test_full_loss_takes_a_prebuilt_csr(model):
    """The loss with the batch's csr equals the loss that builds its own,
    bit for bit; without a label mask every node counts."""
    _, _, tcfg, tp = model
    b = {k: _t(v) for k, v in _full_batch().items()}
    csr = build_csr(b["edge_src"], b["edge_dst"], b["edge_mask"], N)
    with torch.no_grad():
        a = gnn.gin_full_loss(tp, tcfg, b)
        c = gnn.gin_full_loss(tp, tcfg, dict(b, csr=csr))
        d = gnn.gin_full_loss(tp, tcfg, {k: v for k, v in b.items()
                                         if k != "label_mask"})
        logits = gnn.gin_full_forward(tp, tcfg, b["feats"], b["edge_src"],
                                      b["edge_dst"], b["edge_mask"])
    assert torch.equal(a, c)
    want = -torch.log_softmax(logits, -1).gather(
        1, b["labels"].long()[:, None]).mean()
    torch.testing.assert_close(d, want, rtol=1e-6, atol=0)


def test_bridge_checks_every_key(model):
    jax, _, _ = _jax()
    jcfg, jp, tcfg, _ = model
    arrays = _arrays(jax, jp)
    keys = sorted(arrays)
    assert "['head']" in keys and "['layers'][2]['eps']" in keys
    assert "['layers'][0]['mlp']['w1']" in keys
    for key in ("['layers'][1]['mlp']['b2']", "['layers'][0]['eps']"):
        with pytest.raises(KeyError):
            bridge.gin_params_from_arrays(
                {k: v for k, v in arrays.items() if k != key}, tcfg,
                device="cpu")
    bad = dict(arrays, **{"['head']": arrays["['head']"][:, :2]})
    with pytest.raises(ValueError):
        bridge.gin_params_from_arrays(bad, tcfg, device="cpu")


def test_init_shapes_and_device():
    cfg = gnn.GINConfig(name="g", n_layers=2, d_hidden=8, d_feat=4,
                        n_classes=3)
    p = gnn.gin_init_params(cfg, seed=0, device="cpu")
    assert [tuple(p["layers"][i]["mlp"]["w1"].shape) for i in (0, 1)] == \
        [(4, 8), (8, 8)]
    assert tuple(p["head"].shape) == (8, 3)
    assert all(float(lp["eps"]) == 0.0 for lp in p["layers"])
    q = gnn.gin_init_params(cfg, seed=0, device="cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
        keyed_leaves(p), keyed_leaves(q)))


# ---------------------------------- twins of test_models_other.py's GIN

def _small_params():
    cfg = gnn.GINConfig(name="g", n_layers=2, d_hidden=8, d_feat=4,
                        n_classes=2)
    return cfg, gnn.gin_init_params(cfg, seed=0, device="cpu")


def test_gin_permutation_invariance():
    """Sum aggregation is invariant to edge-list permutation (allclose:
    another order is another rounding)."""
    cfg, p = _small_params()
    rng = np.random.default_rng(1)
    feats = _t(rng.standard_normal((10, 4)).astype(np.float32))
    src = _t(rng.integers(0, 10, 30))
    dst = _t(rng.integers(0, 10, 30))
    perm = _t(rng.permutation(30))
    with torch.no_grad():
        l1 = gnn.gin_full_forward(p, cfg, feats, src, dst)
        l2 = gnn.gin_full_forward(p, cfg, feats, src[perm], dst[perm])
    np.testing.assert_allclose(l1.numpy(), l2.numpy(), atol=1e-5)


def test_gin_edge_mask_drops_padding():
    cfg, p = _small_params()
    feats = _t(np.random.default_rng(2).standard_normal((10, 4)).astype(
        np.float32))
    src, dst = torch.tensor([0, 1, 2]), torch.tensor([3, 4, 5])
    srcp = torch.cat([src, torch.tensor([7, 8])])
    dstp = torch.cat([dst, torch.tensor([0, 1])])
    mask = torch.tensor([1.0, 1, 1, 0, 0])
    with torch.no_grad():
        l1 = gnn.gin_full_forward(p, cfg, feats, src, dst)
        l2 = gnn.gin_full_forward(p, cfg, feats, srcp, dstp, mask)
    np.testing.assert_allclose(l1.numpy(), l2.numpy(), atol=1e-5)


def test_neighbor_sampler_shapes():
    feats, src, dst, labels = make_random_graph(0, 100, 400, 6, 4)
    b = sample_neighborhood_batch(1, feats, src, dst, labels, 8, (3, 2))
    assert b["feat_l0"].shape == (8, 6)
    assert b["feat_l1"].shape == (8, 3, 6)
    assert b["feat_l2"].shape == (8, 3, 2, 6)
    assert b["labels"].shape == (8,)


# ------------------------------------------- the CUDA kernel (gpu only)

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _kernel_vs_plain(src, dst, mask, n, f, seed):
    """The kernel on both orders against the plain version on host copies
    (bit for bit), repeated bit for bit; its launches counted by order."""
    dev = _cuda()
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, f)).astype(np.float32)
    csr_h = build_csr(_t(src), _t(dst), _t(mask), n)
    csr_d = build_csr(_t(src).to(dev), _t(dst).to(dev), _t(mask).to(dev), n)
    xd = _t(x).to(dev)
    for name in ("fwd", "bwd"):
        order = getattr(csr_d, name)
        before = dict(csr_gather_sum.launches_by_order)
        got = csr_gather_sum(xd, order)
        again = csr_gather_sum(xd, order)
        torch.cuda.synchronize()
        assert csr_gather_sum.launches_by_order[order.by] == \
            before[order.by] + 2
        want = csr_gather_sum_plain(_t(x), getattr(csr_h, name))
        assert torch.equal(got.cpu(), want), (name, f)
        assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("f", [1, 31, 64, 100, 1433])
def test_cuda_kernel_matches_plain_bit_for_bit(f):
    """Ragged power-law degrees, empty rows (a quarter of the nodes get no
    edge and send none), masks 0 and 1 and in between, any F (float4 at
    64 and 100, scalar at 1, 31 and 1433)."""
    rng = np.random.default_rng(f)
    n, e = 3000, 40_000
    w = 1.0 / np.arange(1, 3 * n // 4 + 1) ** 0.5
    src = rng.choice(3 * n // 4, size=e, p=w / w.sum()).astype(np.int32)
    dst = rng.integers(0, 3 * n // 4, e).astype(np.int32)
    mask = rng.choice(np.array([0.0, 1.0, 0.37], np.float32), e)
    _kernel_vs_plain(src, dst, mask, n, f, seed=f + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("f", [64, 100])
def test_cuda_kernel_long_row(f):
    """One 20,000-edge destination row and one 20,000-edge source row
    among short ones (never split: the order of the sum is the row's)."""
    rng = np.random.default_rng(7)
    n, e = 5000, 60_000
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    dst[:20_000] = 17
    src[20_000:40_000] = 4242
    mask = (rng.random(e) > 0.1).astype(np.float32)
    _kernel_vs_plain(src, dst, mask, n, f, seed=8)


@pytest.mark.gpu
def test_cuda_gin_aggregate_forward_and_backward():
    """gin_aggregate on the card: forward and backward bit-equal to the
    CPU route (JAX's bits), one launch of each order, f32 only."""
    dev = _cuda()
    feats, src, dst, mask, _ = _graph(seed=9, n=2000, e=30_000, pad=512,
                                      f=100)
    ct = np.random.default_rng(10).standard_normal(
        (2000, 100)).astype(np.float32)
    outs = []
    for d in ("cpu", dev):
        csr = build_csr(_t(src).to(d), _t(dst).to(d), _t(mask).to(d), 2000)
        h = _t(feats).to(d).requires_grad_()
        n0 = dict(csr_gather_sum.launches_by_order)
        out = gin_aggregate(h, csr)
        (g,) = torch.autograd.grad(out, h, _t(ct).to(d))
        if d != "cpu":
            assert csr_gather_sum.launches_by_order == {
                "dst": n0["dst"] + 1, "src": n0["src"] + 1}
            with pytest.raises(TypeError):
                gin_aggregate(h.detach().double(), csr)
        outs.append((out.detach().cpu(), g.cpu()))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    assert graph_agg.csr_gather_sum is csr_gather_sum
