"""Graph generation and the layered neighbour sampler for sampled GNN
training (port of ``repro.data.graph``, which is numpy only: the same
generator, the same draws, so a seed gives JAX's arrays exactly).

The sampler produces *gathered feature* batches (feat_l0..feat_lD), the
host-side sampler / device-side compute split of distributed GNN
systems: the device never holds the full graph, only fixed-shape fanout
tensors.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["make_random_graph", "sample_neighborhood_batch"]


def make_random_graph(seed: int, n_nodes: int, n_edges: int, d_feat: int,
                      n_classes: int = 8):
    """Power-law-ish random graph as (feats, src, dst, labels) numpy
    arrays: feats (N, F) f32, src / dst (E,) int32 (sources drawn with
    weight 1 / sqrt(rank), destinations uniformly), labels (N,) int32."""
    rng = np.random.default_rng(seed)
    # preferential-attachment-flavored endpoints: degree ~ power law
    w = 1.0 / np.arange(1, n_nodes + 1) ** 0.5
    w /= w.sum()
    src = rng.choice(n_nodes, size=n_edges, p=w)
    dst = rng.integers(0, n_nodes, size=n_edges)
    # community-structured features: label-dependent mean
    labels = rng.integers(0, n_classes, size=n_nodes)
    centers = rng.normal(size=(n_classes, d_feat)).astype(np.float32)
    feats = (centers[labels] +
             0.5 * rng.normal(size=(n_nodes, d_feat))).astype(np.float32)
    return feats, src.astype(np.int32), dst.astype(np.int32), \
        labels.astype(np.int32)


def _build_csr(src, dst, n_nodes):
    """(sources sorted stably by destination, offsets (N + 1,))."""
    order = np.argsort(dst, kind="stable")
    s_sorted = src[order]
    counts = np.bincount(dst, minlength=n_nodes)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    return s_sorted, offsets


def sample_neighborhood_batch(seed: int, feats, src, dst, labels,
                              batch_nodes: int, fanout: Tuple[int, ...]):
    """Uniform fanout sampling -> {feat_l0..feat_lD, labels} fixed shapes.

    feat_ld has shape (batch, f_1, ..., f_d, F); missing neighbors are
    sampled with replacement (standard GraphSAGE practice), and an
    isolated node samples itself.
    """
    rng = np.random.default_rng(seed)
    n_nodes = feats.shape[0]
    in_src, offsets = _build_csr(src, dst, n_nodes)
    seeds = rng.integers(0, n_nodes, size=batch_nodes).astype(np.int32)

    def sample_neighbors(nodes, fan):
        flat = nodes.reshape(-1)
        out = np.empty((flat.shape[0], fan), np.int32)
        for i, v in enumerate(flat):
            lo, hi = offsets[v], offsets[v + 1]
            if hi > lo:
                out[i] = in_src[rng.integers(lo, hi, size=fan)]
            else:
                out[i] = v                      # isolated: self-loop
        return out.reshape(nodes.shape + (fan,))

    levels = [seeds]
    for fan in fanout:
        levels.append(sample_neighbors(levels[-1], fan))
    batch = {f"feat_l{d}": feats[lvl] for d, lvl in enumerate(levels)}
    batch["labels"] = labels[seeds]
    return batch
