"""Carry state built by the JAX package across to the port: an engine's
state, and an LM's parameters.

``state_from_arrays`` takes the state as a ``{keypath: np.ndarray}`` dict,
keyed by the ``jax.tree_util.keystr`` paths of ``EngineState`` leaves: the
paths ``repro/runtime/checkpoint.py`` writes into a snapshot's ``.npz``
(``['state'].corpus``, ``['state'].proj[0]``, ...) or those of a live
engine's state (``.corpus``, ``.proj.params[0]``, ...). The port cannot
reproduce ``jax.random`` streams, so this is how a test serves the very
arrays the JAX package built. ``lm_params_from_arrays`` does the same for
the parameters of ``repro.models.transformer`` (``['embed']``,
``['runs'][0]['wq']``, ...), and ``opt_state_from_arrays`` for the AdamW
state of ``repro.optim`` (``['step']``, ``['m']['embed']``, ...).
``affine_reducer`` wraps a linear baseline's fitted ``(matrix, mean)``
pair (``repro.core.baselines`` pca, rp and mds) as the port's baselines
``Reducer``.
"""
from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch._tree import keyed_leaves, tree_unflatten
from repro_torch.core import baselines
from repro_torch.models.transformer import LMConfig, Params, layer_runs
from repro_torch.search.ivfpq import IVFPQIndex
from repro_torch.search.pq import PQIndex
from repro_torch.search.reducers import Reducer
from repro_torch.search.registry import Index, OPQIndex
from repro_torch.search.serve import EngineState
from repro_torch.search.spec import IndexSpec, parse_spec

__all__ = ["state_from_arrays", "affine_reducer", "lm_params_from_arrays",
           "opt_state_from_arrays"]

_SNAPSHOT_PREFIX = "['state']"
# the NamedTuple payloads, carried field by field
_PAYLOADS = {"pq": PQIndex, "opq": OPQIndex, "ivfpq": IVFPQIndex}
_MLP_PARAMS = ("mean", "lin", "w1", "b1", "w2")


def state_from_arrays(arrays: Mapping[str, np.ndarray],
                      spec: Union[str, IndexSpec],
                      device: DeviceLike = None) -> EngineState:
    """Build the port's ``EngineState`` for ``spec`` from JAX arrays."""
    if isinstance(spec, str):
        spec = parse_spec(spec)
    dev = resolve_device(device)
    flat = {(key[len(_SNAPSHOT_PREFIX):]
             if key.startswith(_SNAPSHOT_PREFIX) else key): val
            for key, val in arrays.items()}

    def get(*keys):
        for key in keys:
            if key in flat:
                arr = np.asarray(flat[key])
                t = torch.from_numpy(np.array(arr, copy=True)).to(dev)
                # ids and posting lists are int64 in the port
                return t.long() if t.dtype == torch.int32 else t
        raise KeyError(f"no array under {' or '.join(keys)}")

    proj = None
    if spec.reduce is not None and spec.reduce.kind == "mlp":
        proj = Reducer("mlp", {name: get(f".proj.params['{name}']")
                               for name in _MLP_PARAMS})
    elif spec.reduce is not None:
        # qpad and pca: the affine (matrix, mean) pair, under the live or
        # the snapshot path (pre-zoo snapshots keep the bare tuple)
        proj = Reducer(spec.reduce.kind,
                       (get(".proj.params[0]", ".proj[0]"),
                        get(".proj.params[1]", ".proj[1]")))
    if spec.kind == "flat":
        payload = get(".index.payload")
    elif spec.kind in _PAYLOADS:
        cls = _PAYLOADS[spec.kind]
        payload = cls(**{f: get(f".index.payload.{f}") for f in cls._fields})
    else:
        raise NotImplementedError(
            f"index kind {spec.kind!r} is not ported yet (see ROADMAP.md)")
    return EngineState(corpus=get(".corpus"), proj=proj,
                       index=Index(spec.kind, payload))


def affine_reducer(name: str, matrix: np.ndarray, mean: np.ndarray,
                   device: DeviceLike = None) -> baselines.Reducer:
    """The port's baselines ``Reducer`` for an affine map given as JAX's
    ``params`` pair: matrix (m, D) and mean (D,), mapping y to
    ``(y - mean) @ matrix.T`` (pca, rp and mds expose this pair)."""
    dev = resolve_device(device)
    mat = torch.from_numpy(np.array(matrix, np.float32, copy=True)).to(dev)
    mu = torch.from_numpy(np.array(mean, np.float32, copy=True)).to(dev)
    return baselines.Reducer(
        name, lambda y: (torch.as_tensor(y, dtype=torch.float32) - mu)
        @ mat.T, params=(mat, mu))


def _tensor(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor with ``arr``'s bits. numpy holds a bf16 JAX array as
    ``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses: its bits
    are carried as uint16 and reinterpreted."""
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(
            np.array(arr.view(np.uint16), copy=True)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def lm_params_from_arrays(arrays: Mapping[str, np.ndarray], cfg: LMConfig,
                          device: DeviceLike = None) -> Params:
    """The port's LM parameters for ``cfg`` from JAX arrays keyed by
    ``jax.tree_util.keystr`` paths, copied bit for bit; each must have the
    shape and dtype ``cfg`` gives it."""
    if cfg.moe is not None:
        raise NotImplementedError("MoE layers are not ported yet (see "
                                  "ROADMAP.md)")
    dev = resolve_device(device)
    d, h, kv, dh, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                       cfg.d_ff)

    def get(key, shape):
        if key not in arrays:
            raise KeyError(f"no array under {key}")
        t = _tensor(np.asarray(arrays[key]))
        if tuple(t.shape) != tuple(shape) or t.dtype != cfg.dtype:
            raise ValueError(f"{key}: {tuple(t.shape)} {t.dtype}, expected "
                             f"{tuple(shape)} {cfg.dtype}")
        return t.to(dev)

    def run(ri, n):
        shapes: Dict[str, tuple] = {
            "ln1": (n, d), "ln2": (n, d), "wq": (n, d, h * dh),
            "wk": (n, d, kv * dh), "wv": (n, d, kv * dh),
            "wo": (n, h * dh, d), "w_gate": (n, d, f), "w_up": (n, d, f),
            "w_down": (n, f, d)}
        return {name: get(f"['runs'][{ri}]['{name}']", shape)
                for name, shape in shapes.items()}

    params = {
        "embed": get("['embed']", (cfg.vocab_padded, d)),
        "final_norm": get("['final_norm']", (d,)),
        "runs": [run(ri, n) for ri, (_, n) in enumerate(layer_runs(cfg))],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = get("['lm_head']", (d, cfg.vocab_padded))
    return params


def opt_state_from_arrays(arrays: Mapping[str, np.ndarray], params: Params,
                          device: DeviceLike = None) -> Dict[str, object]:
    """The port's AdamW state beside ``params`` from the JAX state of
    ``init_opt_state`` / ``adamw_update`` keyed by ``keystr`` paths: the
    int32 ``['step']`` and, for each parameter path P, the f32 moments
    ``['m']P`` and ``['v']P`` of that parameter's shape."""
    dev = resolve_device(device)

    def get(key, shape, dtype):
        if key not in arrays:
            raise KeyError(f"no array under {key}")
        t = _tensor(np.asarray(arrays[key]))
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"{key}: {tuple(t.shape)} {t.dtype}, expected "
                             f"{tuple(shape)} {dtype}")
        return t.to(dev)

    leaves = keyed_leaves(params)

    def moments(name):
        return tree_unflatten(params, [
            get(f"['{name}']{path}", p.shape, torch.float32)
            for path, p in leaves])

    return {"step": get("['step']", (), torch.int32), "m": moments("m"),
            "v": moments("v")}
