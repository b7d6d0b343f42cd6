"""The benchmark's inputs, drawn on the device.

Synthetic sentence-embedding-like vectors: unit-norm rows of low
intrinsic dimension. Cluster centres live in a ``spread``-dim subspace,
each row is offset from its centre in a ``local``-dim subspace, plus small
isotropic noise. The subspaces and centres come from the configuration's
fixed ``structure_seed`` and the corpus rows from its fixed ``data_seed``:
a deployment serves one data set, so every run builds the same index over
the same rows, and the work does not change with the seed. The queries
and the stream's writes come from ``--seed``.

Everything is drawn with a ``torch.Generator`` on the target device, in
chunks, in float32 with TF32 off, so the same seed gives the same bits on
the same device: the reference regenerates the corpus after the window
instead of keeping a second copy.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

_MIX = 0x9E3779B97F4A7C15
_MASK = (1 << 63) - 1

# one stream of draws per purpose, so adding a purpose moves no other
STREAM_CORPUS, STREAM_QUERIES, STREAM_WRITES, STREAM_SAMPLE = 1, 2, 3, 4


def sub_seed(seed: int, stream: int, index: int = 0) -> int:
    """A 63-bit seed for one purpose (and one step) of a run's ``seed``;
    any whole number is accepted, however large."""
    x = (int(seed) * _MIX + stream * 0xBF58476D1CE4E5B9 + index) & _MASK
    x ^= x >> 31
    return (x * 0x94D049BB133111EB) & _MASK


@contextlib.contextmanager
def exact_f32():
    """float32 matmuls without TF32 for the duration (restored after)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


@dataclasses.dataclass(frozen=True)
class Recipe:
    """The configuration's ``synthetic`` block."""
    dim: int
    clusters: int
    spread: int
    local: int
    local_scale: float
    noise: float
    structure_seed: int
    data_seed: int

    @classmethod
    def from_config(cls, config: dict) -> "Recipe":
        s = config["synthetic"]
        return cls(dim=int(config["dim"]), clusters=int(s["clusters"]),
                   spread=int(s["spread"]), local=int(s["local"]),
                   local_scale=float(s["local_scale"]),
                   noise=float(s["noise"]),
                   structure_seed=int(s["structure_seed"]),
                   data_seed=int(s["data_seed"]))


class Generator:
    """Draws rows of one recipe on ``device``."""

    CHUNK = 1 << 20

    def __init__(self, recipe: Recipe, device):
        self.recipe = recipe
        self.device = torch.device(device)
        g = self._gen(recipe.structure_seed)
        d = recipe.dim
        with exact_f32():
            self.b_local = (torch.randn((recipe.local, d), generator=g,
                                        device=self.device) / d ** 0.5)
            b_spread = (torch.randn((recipe.spread, d), generator=g,
                                    device=self.device) / d ** 0.5)
            self.centers = torch.randn((recipe.clusters, recipe.spread),
                                       generator=g,
                                       device=self.device) @ b_spread

    def _gen(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def _rows(self, n: int, g: torch.Generator) -> torch.Tensor:
        r = self.recipe
        with exact_f32():
            lab = torch.randint(0, r.clusters, (n,), generator=g,
                                device=self.device)
            z = torch.randn((n, r.local), generator=g, device=self.device)
            x = self.centers[lab] + r.local_scale * (z @ self.b_local)
            x += r.noise * torch.randn((n, r.dim), generator=g,
                                       device=self.device)
            x /= torch.linalg.vector_norm(x, dim=1, keepdim=True)
        return x

    def rows(self, n: int, seed: int) -> torch.Tensor:
        """(n, dim) float32 rows from ``seed``, drawn in chunks into one
        buffer (so a 30 GB corpus never needs a second copy)."""
        g = self._gen(seed)
        out = torch.empty((n, self.recipe.dim), dtype=torch.float32,
                          device=self.device)
        for s in range(0, n, self.CHUNK):
            e = min(n, s + self.CHUNK)
            out[s:e] = self._rows(e - s, g)
        return out

    def corpus(self, n: int) -> torch.Tensor:
        """The data set: ``n`` rows from the recipe's ``data_seed``."""
        return self.rows(n, sub_seed(self.recipe.data_seed, STREAM_CORPUS))

    def queries(self, n: int, seed: int) -> torch.Tensor:
        return self.rows(n, sub_seed(seed, STREAM_QUERIES))

    def writes(self, n: int, seed: int, step: int) -> torch.Tensor:
        """The vectors a stream step upserts, drawn from the step's own
        seed: the reference draws them again after the window."""
        return self.rows(n, sub_seed(seed, STREAM_WRITES, step))


def checksum(x: torch.Tensor) -> float:
    """An order-fixed digest of a tensor's values: equal bits give equal
    digests (used to show a regenerated corpus is the one served)."""
    n = x.shape[0]
    idx = torch.linspace(0, n - 1, steps=min(n, 4096),
                         device=x.device).long()
    w = torch.arange(1, x.shape[1] + 1, device=x.device,
                     dtype=torch.float64)
    return float((x[idx].double() * w).sum())
