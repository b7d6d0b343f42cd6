"""repro_torch.data.graph against repro.data.graph: the same numpy
generator and draws, so for a seed every array is JAX's exactly (the
random graph, the stable CSR, the sampled fanout batch)."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.data import graph as tgraph  # noqa: E402
from repro_torch.data import (make_random_graph,  # noqa: E402
                              sample_neighborhood_batch)


def _jgraph():
    pytest.importorskip("jax")
    from repro.data import graph as jgraph
    return jgraph


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_random_graph_and_sampler_equal_jax(seed):
    jg = _jgraph()
    n, e, f, c = 200 + seed, 1500, 9, 6
    got = make_random_graph(seed, n, e, f, c)
    want = jg.make_random_graph(seed, n, e, f, c)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    feats, src, dst, labels = got
    for a, b in zip(tgraph._build_csr(src, dst, n),
                    jg._build_csr(src, dst, n)):
        np.testing.assert_array_equal(a, b)
    for fanout in ((3, 2), (4,)):
        tb = sample_neighborhood_batch(seed + 1, feats, src, dst, labels, 16,
                                       fanout)
        jb = jg.sample_neighborhood_batch(seed + 1, feats, src, dst, labels,
                                          16, fanout)
        assert sorted(tb) == sorted(jb)
        for k in jb:
            assert tb[k].dtype == jb[k].dtype
            np.testing.assert_array_equal(tb[k], jb[k])


def test_isolated_nodes_sample_themselves():
    """A node with no in-edges samples itself (a self-loop), in both."""
    jg = _jgraph()
    feats = np.arange(10, dtype=np.float32)[:, None] * np.ones((1, 3),
                                                                np.float32)
    src = np.array([1, 2, 3], np.int32)
    dst = np.array([0, 0, 1], np.int32)
    labels = np.arange(10, dtype=np.int32)
    tb = sample_neighborhood_batch(4, feats, src, dst, labels, 12, (2,))
    jb = jg.sample_neighborhood_batch(4, feats, src, dst, labels, 12, (2,))
    for k in jb:
        np.testing.assert_array_equal(tb[k], jb[k])
    seeds = tb["labels"]
    for i, v in enumerate(seeds):
        if v >= 2:                               # no in-edges
            np.testing.assert_array_equal(tb["feat_l1"][i, :, 0], v)
