"""Port parity of the recsys family (twins of tests/test_models_other.py's
recsys and embedding tests and of tests/test_retrieval_modes.py):
repro_torch.models.{embedding,recsys} against repro.models' on the same
parameters (carried over by bridge.params_from_arrays): each model's
forward, loss and gradients, the serve paths' ids (SASRec's blocked
top-k, DIEN's and AutoInt's candidate scoring, the two-tower retrieval in
its full, MPAD-reduced and int8 modes), quantize_candidates and
hash_bucket bit for bit; the recsys batches of data.pipeline; and
configs.recsys_family's shapes and FLOP counts against JAX's arch specs."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes at once: one intra-op thread
# each keeps torch's many small CPU ops from contending for the cores
torch.set_num_threads(1)

from repro_torch import bridge  # noqa: E402
from repro_torch._tree import keyed_leaves, tree_map  # noqa: E402
from repro_torch.configs import recsys_family  # noqa: E402
from repro_torch.configs.registry import config_module  # noqa: E402
from repro_torch.data import recsys_ranking_batch, twotower_batch  # noqa
from repro_torch.models import recsys as rs  # noqa: E402
from repro_torch.models.embedding import (embedding_bag,  # noqa: E402
                                          embedding_lookup, hash_bucket)
from repro_torch.optim import adamw  # noqa: E402

# f32 forward outputs and losses: the same operations in another order
# (matmul blocking, softmax and norm sums); measured <= 1e-6 here
ATOL = 1e-5
LOSS_RTOL = 1e-5
# each gradient leaf's relative L2 distance to JAX's, the bound of
# tests/test_torch_train.py: measured ~1e-6 here
GRAD_REL = 1e-5


def _jax():
    """JAX is imported by the parity tests only: the machine with the card
    has no JAX."""
    jax = pytest.importorskip("jax")
    from repro.models import recsys as jrs
    return jax, jax.numpy, jrs


def _arrays(jax, tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf
            in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _t(a):
    return torch.from_numpy(np.array(a))


# the small configurations of tests/test_models_other.py and
# tests/test_retrieval_modes.py
_CFGS = {
    "sasrec": dict(name="s", n_items=64, seq_len=8),
    "dien": dict(name="d", n_items=40, n_cats=5, seq_len=6),
    "autoint": dict(name="a", n_fields=5, vocab_per_field=30),
    "twotower": dict(name="t", n_users=300, n_items=400, n_negatives=8),
}
_CLASSES = {"sasrec": ("SASRecConfig", "sasrec_init"),
            "dien": ("DIENConfig", "dien_init"),
            "autoint": ("AutoIntConfig", "autoint_init"),
            "twotower": ("TwoTowerConfig", "twotower_init")}


@pytest.fixture(scope="module")
def models():
    """(JAX cfg, JAX params, port cfg, port params) a family, the port's
    carried over from JAX's by bridge.params_from_arrays."""
    cache = {}

    def get(family):
        if family not in cache:
            jax, _, jrs = _jax()
            cls, init = _CLASSES[family]
            jcfg = getattr(jrs, cls)(**_CFGS[family])
            tcfg = getattr(rs, cls)(**_CFGS[family])
            jp = getattr(jrs, init)(jax.random.key(0), jcfg)
            template = getattr(rs, init)(tcfg, seed=0, device="cpu")
            tp = bridge.params_from_arrays(_arrays(jax, jp), template,
                                           device="cpu")
            cache[family] = (jcfg, jp, tcfg, tp)
        return cache[family]

    return get


def _grads_match(jax, jloss_fn, jp, tloss_fn, tp, batch_np):
    """Loss and every gradient leaf against jax.value_and_grad."""
    jb = {k: jax.numpy.asarray(v) for k, v in batch_np.items()}
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jloss_fn(p, jb)))(jp)
    want = _arrays(jax, jg)
    tb = {k: _t(v) for k, v in batch_np.items()}
    # a copy: value_and_grad marks the leaves it is given
    tl, tg = adamw.value_and_grad(
        tloss_fn, tree_map(lambda t: t.detach().clone(), tp), tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    got = dict(keyed_leaves(tg))
    assert sorted(got) == sorted(want)
    for key, g in got.items():
        den = np.linalg.norm(want[key])
        rel = np.linalg.norm(g.numpy() - want[key]) / max(den, 1e-30)
        assert rel <= GRAD_REL or den <= 1e-7, (key, rel, den)


# ----------------------------------------------------------- embedding

def test_embedding_bag_modes_match_jax():
    """sum / mean / max over -1-padded bags, an empty bag among them."""
    _, jnp, _ = _jax()
    from repro.models.embedding import embedding_bag as jbag
    table = (np.arange(20, dtype=np.float32).reshape(10, 2) - 7.0) * 0.5
    ids = np.array([[1, 3, -1], [0, -1, -1], [-1, -1, -1], [9, 9, 2]])
    for mode in ("sum", "mean", "max"):
        got = embedding_bag(_t(table), _t(ids), mode)
        want = np.asarray(jbag(jnp.asarray(table), jnp.asarray(ids), mode))
        np.testing.assert_array_equal(got.numpy(), want)
    got = embedding_bag(_t(table), _t(ids), "max")
    np.testing.assert_array_equal(got[0].numpy(),
                                  np.maximum(table[1], table[3]))
    np.testing.assert_array_equal(got[2].numpy(), 0.0)
    with pytest.raises(ValueError):
        embedding_bag(_t(table), _t(ids), "median")


def test_embedding_lookup_negative_ids_zero():
    out = embedding_lookup(torch.ones((5, 3)), torch.tensor([-1, 2]))
    np.testing.assert_array_equal(out[0].numpy(), 0.0)
    np.testing.assert_array_equal(out[1].numpy(), 1.0)


@pytest.mark.parametrize("salt", [0, 7, 2**32 - 3])
def test_hash_bucket_bit_equal_to_jax(salt):
    """JAX's uint32 wrap: negative ids, ids near 2^31, the salt's wrap;
    every bucket in range."""
    jax, jnp, _ = _jax()
    from repro.models.embedding import hash_bucket as jhash
    rng = np.random.default_rng(salt % 1000)
    ids = np.concatenate([
        rng.integers(-2**31, 2**31 - 1, 200),
        [-1, -2, 0, 1, 2**31 - 1, -2**31, 2654435761 % 2**31]]).astype(
            np.int32)
    for buckets in (2, 1000, 2**20 + 7, 2**31 - 1):
        got = hash_bucket(_t(ids), buckets, salt)
        want = np.asarray(jhash(jnp.asarray(ids), buckets, salt))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        assert int(got.min()) >= 0 and int(got.max()) < buckets


# --------------------------------------------------------------- SASRec

def test_sasrec_forward_and_padding_match_jax(models):
    jax, jnp, jrs = _jax()
    jcfg, jp, tcfg, tp = models("sasrec")
    seq = np.array([[1, 2, 3, -1, -1, -1, -1, -1],
                    [5, 63, 0, 7, 7, 9, 10, 11]])
    got = rs.sasrec_forward(tp, tcfg, _t(seq))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jrs.sasrec_forward(jp, jcfg,
                                                   jnp.asarray(seq))),
        atol=ATOL)
    np.testing.assert_array_equal(got[0, 3:].numpy(), 0.0)  # padded zeroed


def test_sasrec_loss_and_grads_match_jax(models):
    jax, _, jrs = _jax()
    jcfg, jp, tcfg, tp = models("sasrec")
    rng = np.random.default_rng(1)
    batch = {k: rng.integers(0, 64, (3, 8)) for k in ("seq", "pos", "neg")}
    batch["pos"][0, :2] = -1
    batch["seq"][1, 5:] = -1
    _grads_match(jax, lambda p, b: jrs.sasrec_loss(p, jcfg, b), jp,
                 lambda p, b: rs.sasrec_loss(p, tcfg, b), tp, batch)


@pytest.mark.parametrize("k,chunk", [(5, 16), (5, 24), (20, 64), (64, 8)])
def test_sasrec_serve_topk_matches_jax_and_dense(models, k, chunk):
    """The blocked running top-k (chunk 24 falls back to its gcd with 64):
    the ids equal JAX's and a one-shot top-k over the dense scores."""
    jax, jnp, jrs = _jax()
    jcfg, jp, tcfg, tp = models("sasrec")
    seq = np.random.default_rng(2).integers(0, 64, (3, 8))
    sj, ij = jrs.sasrec_serve_topk(jp, jcfg, jnp.asarray(seq), k=k,
                                   item_chunk=chunk)
    st, it = rs.sasrec_serve_topk(tp, tcfg, _t(seq), k=k, item_chunk=chunk)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=ATOL)
    with torch.no_grad():
        h = rs.sasrec_forward(tp, tcfg, _t(seq))[:, -1]
        dv, di = torch.sort(h @ tp["item_emb"].T, dim=1, descending=True,
                            stable=True)
    np.testing.assert_array_equal(it.numpy(), di[:, :k].numpy())
    np.testing.assert_allclose(st.numpy(), dv[:, :k].numpy(), atol=ATOL)


# ----------------------------------------------------------------- DIEN

def _dien_batch(b, seed):
    rng = np.random.default_rng(seed)
    batch = {"hist_items": rng.integers(0, 40, (b, 6)),
             "hist_cats": rng.integers(0, 5, (b, 6)),
             "target_item": rng.integers(0, 40, (b,)),
             "target_cat": rng.integers(0, 5, (b,)),
             "neg_items": rng.integers(0, 40, (b, 6)),
             "neg_cats": rng.integers(0, 5, (b, 6)),
             "label": (rng.random(b) > 0.5).astype(np.float32)}
    batch["hist_items"][0, 4:] = -1           # a padded history tail
    return batch


def test_dien_forward_matches_jax(models):
    jax, jnp, jrs = _jax()
    jcfg, jp, tcfg, tp = models("dien")
    batch = _dien_batch(4, 3)
    lj, sj = jrs.dien_forward(jp, jcfg, {k: jnp.asarray(v)
                                         for k, v in batch.items()})
    lt, st = rs.dien_forward(tp, tcfg, {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(lt.detach().numpy(), np.asarray(lj),
                               atol=ATOL)
    np.testing.assert_allclose(st.detach().numpy(), np.asarray(sj),
                               atol=ATOL)


def test_dien_loss_and_grads_match_jax(models):
    jax, _, jrs = _jax()
    jcfg, jp, tcfg, tp = models("dien")
    _grads_match(jax, lambda p, b: jrs.dien_loss(p, jcfg, b), jp,
                 lambda p, b: rs.dien_loss(p, tcfg, b), tp,
                 _dien_batch(4, 4))


@pytest.mark.parametrize("chunk", [3, 4096])
def test_dien_score_matches_jax_and_forward(models, chunk):
    """One history against 8 candidates (chunks of 3: a ragged last one):
    JAX's dien_score within ATOL, and dien_forward on the same (history,
    target) pairs within JAX's test's tolerance (rtol 1e-4, atol 1e-5)."""
    jax, jnp, jrs = _jax()
    jcfg, jp, tcfg, tp = models("dien")
    rng = np.random.default_rng(5)
    hist_i, hist_c = rng.integers(0, 40, (1, 6)), rng.integers(0, 5, (1, 6))
    hist_i[0, 5] = -1
    cands, ccats = np.arange(8), np.array([0, 1, 2, 3, 4, 0, 1, 2])
    jb = {"hist_items": hist_i, "hist_cats": hist_c, "cand_items": cands,
          "cand_cats": ccats}
    want = np.asarray(jrs.dien_score(jp, jcfg, {k: jnp.asarray(v)
                                                for k, v in jb.items()}))
    bulk = rs.dien_score(tp, tcfg, {k: _t(v) for k, v in jb.items()},
                         chunk=chunk)
    np.testing.assert_allclose(bulk.numpy(), want, atol=ATOL)
    for j in (0, 5, 7):
        one, _ = rs.dien_forward(tp, tcfg, {
            "hist_items": _t(hist_i), "hist_cats": _t(hist_c),
            "target_item": _t(cands[j:j + 1]),
            "target_cat": _t(ccats[j:j + 1])})
        np.testing.assert_allclose(float(bulk[j]), float(one[0]), rtol=1e-4,
                                   atol=1e-5)


# -------------------------------------------------------------- AutoInt

def test_autoint_forward_and_candidates_match_jax(models):
    jax, jnp, jrs = _jax()
    jcfg, jp, tcfg, tp = models("autoint")
    rng = np.random.default_rng(6)
    fields = rng.integers(0, 30, (6, 5))
    np.testing.assert_allclose(
        rs.autoint_forward(tp, tcfg, _t(fields)).detach().numpy(),
        np.asarray(jrs.autoint_forward(jp, jcfg, jnp.asarray(fields))),
        atol=ATOL)
    user, cands = rng.integers(0, 30, (4,)), np.arange(8)
    bulk = rs.autoint_score_candidates(tp, tcfg, _t(user), _t(cands),
                                       chunk=4)
    np.testing.assert_allclose(
        bulk.numpy(), np.asarray(jrs.autoint_score_candidates(
            jp, jcfg, jnp.asarray(user), jnp.asarray(cands), chunk=4)),
        atol=ATOL)
    rows = np.concatenate([cands[:, None],
                           np.broadcast_to(user[None], (8, 4))], axis=1)
    np.testing.assert_allclose(
        bulk.numpy(), rs.autoint_forward(tp, tcfg, _t(rows)).detach().numpy(),
        atol=ATOL)
    with pytest.raises(ValueError, match="divide"):
        rs.autoint_score_candidates(tp, tcfg, _t(user), _t(cands), chunk=3)


def test_autoint_loss_and_grads_match_jax(models):
    jax, _, jrs = _jax()
    jcfg, jp, tcfg, tp = models("autoint")
    rng = np.random.default_rng(7)
    batch = {"field_ids": rng.integers(0, 30, (8, 5)),
             "label": (rng.random(8) > 0.5).astype(np.float32)}
    _grads_match(jax, lambda p, b: jrs.autoint_loss(p, jcfg, b), jp,
                 lambda p, b: rs.autoint_loss(p, tcfg, b), tp, batch)


# ------------------------------------------------------------ Two-tower

def test_twotower_towers_and_loss_match_jax(models):
    """Normalized towers (the user's history bag -1-padded) and the
    sampled-softmax loss with its gradients."""
    jax, jnp, jrs = _jax()
    jcfg, jp, tcfg, tp = models("twotower")
    rng = np.random.default_rng(8)
    uid = np.arange(5)
    hist = rng.integers(0, 400, (5, tcfg.n_user_feats))
    hist[1, 3:] = -1
    u = rs.twotower_user(tp, tcfg, _t(uid), _t(hist)).detach()
    np.testing.assert_allclose(
        u.numpy(), np.asarray(jrs.twotower_user(jp, jcfg, jnp.asarray(uid),
                                                jnp.asarray(hist))),
        atol=ATOL)
    np.testing.assert_allclose(torch.linalg.vector_norm(u, dim=1).numpy(),
                               1.0, rtol=1e-4)
    batch = {"user_ids": uid, "hist_ids": hist,
             "pos_items": rng.integers(0, 400, (5,)),
             "neg_items": rng.integers(0, 400, (8,)),
             "neg_logq": np.full((8,), -np.log(400.0), np.float32)}
    _grads_match(jax, lambda p, b: jrs.twotower_loss(p, jcfg, b), jp,
                 lambda p, b: rs.twotower_loss(p, tcfg, b), tp, batch)


@pytest.fixture(scope="module")
def retrieval(models):
    """test_retrieval_modes.py's setup in both packages: JAX's candidate
    embeddings, its MPAD fit (m 32), the reduced and int8 caches; the
    port's from the same arrays."""
    jax, jnp, jrs = _jax()
    from repro.core import MPADConfig, fit_mpad
    jcfg, jp, tcfg, tp = models("twotower")
    cand = jrs.twotower_item(jp, jcfg, jnp.arange(jcfg.n_items))
    red = fit_mpad(cand, MPADConfig(m=32, iters=32))
    cr = (cand - red.mean) @ red.matrix.T
    cq, scale = jrs.quantize_candidates(cr)
    jbatch = {"user_ids": jnp.arange(1), "hist_ids": jnp.arange(8)[None, :],
              "cand_emb": cand, "cand_red": cr, "cand_red_q": cq,
              "cand_scale": scale}
    tbatch = {k: _t(v) for k, v in jbatch.items()}
    return (jcfg, jp, tcfg, tp, jbatch, tbatch, (red.matrix, red.mean),
            (_t(red.matrix), _t(red.mean)))


@pytest.mark.parametrize("mode", ["full", "mpad", "mpad_in_step", "int8"])
@pytest.mark.parametrize("k,rerank", [(10, 100), (5, 20)])
def test_twotower_retrieve_ids_match_jax(retrieval, mode, k, rerank):
    """The ids of every mode equal JAX's on the same candidate cache and
    reducer (mpad_in_step: the reduced cache formed inside the call);
    the returned scores are the exact u . cand[id]."""
    jax, jnp, jrs = _jax()
    jcfg, jp, tcfg, tp, jb, tb, jred, tred = retrieval
    keep = {"full": ("user_ids", "hist_ids", "cand_emb"),
            "mpad": ("user_ids", "hist_ids", "cand_emb", "cand_red"),
            "mpad_in_step": ("user_ids", "hist_ids", "cand_emb"),
            "int8": ("user_ids", "hist_ids", "cand_emb", "cand_red_q",
                     "cand_scale")}[mode]
    kw = {} if mode == "full" else dict(rerank=rerank,
                                        quantized=mode == "int8")
    sj, ij = jrs.twotower_retrieve(
        jp, jcfg, {n: jb[n] for n in keep}, k=k,
        reducer=None if mode == "full" else jred, **kw)
    st, it = rs.twotower_retrieve(
        tp, tcfg, {n: tb[n] for n in keep}, k=k,
        reducer=None if mode == "full" else tred, **kw)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=ATOL)
    u = rs.twotower_user(tp, tcfg, tb["user_ids"], tb["hist_ids"])
    np.testing.assert_allclose(
        st.numpy(), (u @ tb["cand_emb"][it].T)[0].detach().numpy(),
        rtol=1e-6, atol=1e-6)


def test_modes_agree_through_rerank(retrieval):
    """tests/test_retrieval_modes.py's claim on the port: the re-rank
    recovers most of the exact top-10, int8 costs little extra."""
    _, _, tcfg, tp, _, tb, _, tred = retrieval
    base = {n: tb[n] for n in ("user_ids", "hist_ids", "cand_emb")}
    _, i0 = rs.twotower_retrieve(tp, tcfg, base, k=10)
    _, i1 = rs.twotower_retrieve(tp, tcfg, dict(base, cand_red=tb[
        "cand_red"]), k=10, reducer=tred, rerank=100)
    _, i2 = rs.twotower_retrieve(
        tp, tcfg, dict(base, cand_red_q=tb["cand_red_q"],
                       cand_scale=tb["cand_scale"]),
        k=10, reducer=tred, rerank=100, quantized=True)
    ov1 = len(set(i0.tolist()) & set(i1.tolist()))
    ov2 = len(set(i0.tolist()) & set(i2.tolist()))
    assert ov1 >= 7, ov1
    assert ov2 >= ov1 - 2, (ov1, ov2)


@pytest.mark.parametrize("scale", [1.0, 3.0, 1e-3])
def test_quantize_candidates_bit_equal_to_jax(scale):
    """The int8 codes and the scales bit for bit (round half to even, the
    clip at +-127), halves and a column of zeros among the inputs; the
    round trip within half a step."""
    jax, jnp, jrs = _jax()
    x = (jax.random.normal(jax.random.key(1), (100, 16)) * scale)
    x = np.array(x)
    x[:4, 0] = np.array([0.5, -0.5, 1.5, 2.5], np.float32) * x[:, 0].max() \
        / 127.0
    x[:, 5] = 0.0
    qj, sj = jrs.quantize_candidates(jnp.asarray(x))
    qt, st = rs.quantize_candidates(_t(x))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy().view(np.int32),
                                  np.asarray(sj).view(np.int32))
    err = np.abs(qt.numpy().astype(np.float32) * st.numpy()[None] - x)
    assert float(err.max()) <= float(st.max()) * 0.51 + 1e-6


# ------------------------------------------------------- data and config

def test_recsys_batches_have_jax_fields_shapes_and_dtypes():
    jax, _, _ = _jax()
    from repro.data import pipeline as jpipe
    jr = jpipe.recsys_ranking_batch(jax.random.key(0), 4, 6, 50, 7)
    tr = recsys_ranking_batch(0, 4, 6, 50, 7, device="cpu")
    jt = jpipe.twotower_batch(jax.random.key(0), 4, 30, 50, 8, 16)
    tt = twotower_batch(torch.Generator().manual_seed(0), 4, 30, 50, 8, 16,
                        device="cpu")
    for jb, tb in ((jr, tr), (jt, tt)):
        assert sorted(jb) == sorted(tb)
        for key in jb:
            assert tuple(tb[key].shape) == tuple(jb[key].shape), key
            assert str(tb[key].dtype).split(".")[-1] == \
                np.dtype(jb[key].dtype).name, key
    assert int(tr["hist_items"].max()) < 50 and int(tr["hist_cats"].max()) < 7
    assert set(tr["label"].tolist()) <= {0.0, 1.0}
    np.testing.assert_array_equal(tt["neg_logq"].numpy(),
                                  np.asarray(jt["neg_logq"]))
    again = recsys_ranking_batch(0, 4, 6, 50, 7, device="cpu")
    assert all(torch.equal(tr[k], again[k]) for k in tr)


def test_recsys_family_matches_jax_shapes_and_flops():
    """RECSYS_SHAPES and every family's FLOP count at every shape equal
    JAX's arch specs' for the published CONFIGs."""
    _jax()
    import importlib
    from repro.configs import recsys_family as jfam
    from repro.configs.registry import ARCH_MODULES
    assert recsys_family.RECSYS_SHAPES == jfam.RECSYS_SHAPES
    assert recsys_family._TOPK == jfam._TOPK
    flops = {"sasrec": recsys_family.sasrec_flops,
             "dien": recsys_family.dien_flops,
             "autoint": recsys_family.autoint_flops,
             "two-tower-retrieval": recsys_family.twotower_flops}
    for name, fn in flops.items():
        arch = importlib.import_module(ARCH_MODULES[name]).get_arch()
        cfg = config_module(name).CONFIG
        for sname in jfam.RECSYS_SHAPES:
            assert fn(cfg, sname) == arch.model_flops(sname), (name, sname)
    assert dataclasses.asdict(config_module("sasrec").CONFIG)["n_items"] \
        == 2 ** 20
