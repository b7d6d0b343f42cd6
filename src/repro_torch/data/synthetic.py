"""Synthetic stand-ins for the paper's four evaluation datasets (Table 4),
port of ``repro.data.synthetic``.

Each generator is shape-matched to the original and reproduces the
structural property that makes neighbour-preserving DR non-trivial:
**heavy-tailed nuisance dimensions** (an informative mixture subspace of
moderate variance that carries the k-NN structure, plus sparse-spike
dimensions of higher variance and no neighbour information).

The generators draw from the same distributions as the JAX ones, in the
same order, on a ``torch.Generator`` (CPU, so a seed gives the same data
whatever the device); ``jax.random`` streams differ, so a test that holds
the port against JAX feeds both packages the same numpy data instead.
Every generator returns (train (N, n), test (d, n)) float32 on the CPU.
"""
from __future__ import annotations

import torch

__all__ = ["make_fasttext_like", "make_isolet_like", "make_arcene_like",
           "make_pbmc3k_like", "PAPER_DATASETS", "make_clustered",
           "make_informative_plus_spikes"]


def make_clustered(gen: torch.Generator, n_train, n_test, dim,
                   n_clusters=16, spread=0.35, center_scale=1.0):
    """Generic gaussian-mixture workhorse used by tests and examples."""
    centers = torch.randn((n_clusters, dim), generator=gen) * center_scale
    lab = torch.randint(0, n_clusters, (n_train,), generator=gen)
    xtr = centers[lab] + spread * torch.randn((n_train, dim), generator=gen)
    lab2 = torch.randint(0, n_clusters, (n_test,), generator=gen)
    xte = centers[lab2] + spread * torch.randn((n_test, dim), generator=gen)
    return xtr.float(), xte.float()


def make_informative_plus_spikes(gen: torch.Generator, n, d_inf, d_spike, *,
                                 n_clusters=32, spread=0.35, spike_prob=0.03,
                                 spike_scale=8.0, floor=0.02,
                                 center_scale=1.0, nonneg=False):
    """Informative cluster subspace + heavy-tailed sparse-spike nuisance."""
    centers = torch.randn((n_clusters, d_inf), generator=gen) * center_scale
    lab = torch.randint(0, n_clusters, (n,), generator=gen)
    inf = centers[lab] + spread * torch.randn((n, d_inf), generator=gen)
    mask = torch.rand((n, d_spike), generator=gen) < spike_prob
    big = torch.randn((n, d_spike), generator=gen) * spike_scale
    small = floor * torch.randn((n, d_spike), generator=gen)
    spikes = torch.where(mask, big, small)
    if nonneg:
        inf, spikes = torch.relu(inf), spikes.abs()
    return torch.cat([inf, spikes], dim=1).float()


def make_fasttext_like(gen: torch.Generator, n_train=2000, n_test=600,
                       dim=300):
    """300-d word-vector-ish: 64 semantic clusters in a 60-d informative
    subspace + 240 heavy-tailed 'frequency' dims."""
    d_inf = 60

    def mk(n):
        return make_informative_plus_spikes(
            gen, n, d_inf, dim - d_inf, n_clusters=64, spread=0.35,
            spike_prob=0.03, spike_scale=8.0)

    return mk(n_train), mk(n_test)


def make_isolet_like(gen: torch.Generator, n_train=2000, n_test=600,
                     dim=617):
    """617-d spoken-letter features: 26 classes, smooth correlated
    informative block + bursty noise bands."""
    d_inf = 120
    kern = torch.exp(-0.5 * (torch.arange(-5, 6, dtype=torch.float32)
                             / 2.0) ** 2)
    kern = kern / kern.sum()

    def mk(n):
        x = make_informative_plus_spikes(
            gen, n, d_inf, dim - d_inf, n_clusters=26, spread=0.45,
            spike_prob=0.05, spike_scale=6.0)
        # jnp.convolve(row, kern, mode="same") per row: a correlation with
        # the flipped kernel, centred
        out = torch.nn.functional.conv1d(x[:, None, :],
                                         kern.flip(0)[None, None, :],
                                         padding=kern.shape[0] // 2)
        return out[:, 0, :].float()

    return mk(n_train), mk(n_test)


def make_arcene_like(gen: torch.Generator, n_train=700, n_test=297,
                     dim=10000):
    """10000-d mass-spectrometry: 2 classes on a broad informative block of
    non-negative peaks; the rest are 'probe' dims with rare large peaks
    (sparse, heavy-tailed, non-negative)."""
    d_inf = 2000        # informative peaks spread broadly (survives the
    # paper's 200-dim column subsampling protocol)

    def mk(n):
        return make_informative_plus_spikes(
            gen, n, d_inf, dim - d_inf, n_clusters=2, spread=0.5,
            spike_prob=0.01, spike_scale=10.0, nonneg=True, center_scale=1.5)

    return mk(n_train), mk(n_test)


def make_pbmc3k_like(gen: torch.Generator, n_train=2038, n_test=600,
                     dim=1838):
    """1838-gene scRNA-seq: 8 cell types in a moderate informative block;
    nuisance genes are dropout-dominated with bursty expression."""
    d_inf = 200

    def mk(n):
        x = make_informative_plus_spikes(
            gen, n, d_inf, dim - d_inf, n_clusters=8, spread=0.4,
            spike_prob=0.02, spike_scale=7.0)
        # library-size multiplicative noise + per-gene standardization
        lib = torch.exp(0.2 * torch.randn((n, 1), generator=gen))
        x = x * lib
        return ((x - x.mean(dim=0)) / (x.std(dim=0, correction=0)
                                       + 1e-6)).float()

    return mk(n_train), mk(n_test)


# name -> (generator, paper sample dim, paper test size); the benchmark
# harness subsamples dims/points to the paper's Table 4 protocol.
PAPER_DATASETS = {
    "fasttext": (make_fasttext_like, 300, 600),
    "isolet": (make_isolet_like, 200, 600),
    "arcene": (make_arcene_like, 200, 297),
    "pbmc3k": (make_pbmc3k_like, 200, 600),
}
