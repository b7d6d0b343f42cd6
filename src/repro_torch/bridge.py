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
``['runs'][0]['wq']``, an MoE layer's ``['runs'][0]['moe']['router']``,
...), ``params_from_arrays`` for any parameter tree whose shape the port
can build (the recsys models' ``['blocks'][0]['wq']``,
``['user_mlp'][1]['b']``, ...), ``gin_params_from_arrays`` for GIN's
(``['layers'][0]['mlp']['w1']``, ``['layers'][0]['eps']``, ``['head']``),
and ``opt_state_from_arrays`` for the
AdamW state of ``repro.optim`` (``['step']``, ``['m']['embed']``, ...).
``affine_reducer`` wraps a linear baseline's fitted ``(matrix, mean)``
pair (``repro.core.baselines`` pca, rp and mds) as the port's baselines
``Reducer``. ``stream_from_arrays`` carries a streaming engine's
``StreamStore`` and ``FrozenParams`` across, keyed as the JAX snapshot
keys them (``['store'].corpus``, ``['frozen'].quant.payload.codebooks``,
...). ``repro_torch.search.snapshot.load_engine`` reads every snapshot
through these two readers.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple, Union

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch._tree import keyed_leaves, tree_unflatten
from repro_torch.core import baselines
from repro_torch.models.gnn import GINConfig, gin_init_params
from repro_torch.models.transformer import (LMConfig, Params,
                                            lm_init_params)
from repro_torch.search.ivf import IVFIndex
from repro_torch.search.ivfpq import IVFPQIndex
from repro_torch.search.pq import PQIndex
from repro_torch.search.reducers import Reducer
from repro_torch.search.registry import (Index, IVFPQQuant, OPQIndex,
                                         OPQQuant, PQQuant)
from repro_torch.search.segments import FrozenParams, StreamStore
from repro_torch.search.serve import EngineState
from repro_torch.search.spec import IndexSpec, parse_spec

__all__ = ["state_from_arrays", "stream_from_arrays", "affine_reducer",
           "lm_params_from_arrays", "gin_params_from_arrays",
           "params_from_arrays", "opt_state_from_arrays"]

_SNAPSHOT_PREFIX = "['state']"
# the NamedTuple payloads, carried field by field
_PAYLOADS = {"ivf": IVFIndex, "pq": PQIndex, "opq": OPQIndex,
             "ivfpq": IVFPQIndex}
_QUANTS = {"pq": PQQuant, "opq": OPQQuant, "ivfpq": IVFPQQuant}
_MLP_PARAMS = ("mean", "lin", "w1", "b1", "w2")
# leaves that hold ids, posting lists or counters: int32 in the JAX
# package, int64 (PyTorch's index type) in the port; codes keep their
# uint8 / int32
_ID_FIELDS = ("row_ids", "n_rows", "lists", "delta_ids", "delta_count")


def _getter(flat: Mapping[str, np.ndarray], dev: torch.device):
    """``get(*keys)``: the first key present, as a tensor on ``dev``; ids,
    lists and counters widened to int64."""
    def get(*keys):
        for key in keys:
            if key in flat:
                arr = np.asarray(flat[key])
                t = torch.from_numpy(np.array(arr, copy=True)).to(dev)
                if key.rsplit(".", 1)[-1] in _ID_FIELDS:
                    t = t.long()
                return t
        raise KeyError(f"no array under {' or '.join(keys)}")
    return get


def _reducer(get, spec: IndexSpec, prefix: str):
    if spec.reduce is None:
        return None
    if spec.reduce.kind == "mlp":
        # a live engine's path, or a snapshot's (the raw params dict)
        return Reducer("mlp", {name: get(f"{prefix}.params['{name}']",
                                         f"{prefix}['{name}']")
                               for name in _MLP_PARAMS})
    # qpad and pca: the affine (matrix, mean) pair, under the live or the
    # snapshot path (pre-zoo snapshots keep the bare tuple)
    return Reducer(spec.reduce.kind,
                   (get(f"{prefix}.params[0]", f"{prefix}[0]"),
                    get(f"{prefix}.params[1]", f"{prefix}[1]")))


def state_from_arrays(arrays: Mapping[str, np.ndarray],
                      spec: Union[str, IndexSpec],
                      device: DeviceLike = None) -> EngineState:
    """Build the port's ``EngineState`` for ``spec`` from JAX arrays. The
    payload of flat with no Reduce stage is the corpus, one tensor (a
    snapshot holds it once)."""
    if isinstance(spec, str):
        spec = parse_spec(spec)
    dev = resolve_device(device)
    get = _getter({(key[len(_SNAPSHOT_PREFIX):]
                    if key.startswith(_SNAPSHOT_PREFIX) else key): val
                   for key, val in arrays.items()}, dev)
    proj = _reducer(get, spec, ".proj")
    corpus = get(".corpus")
    if spec.kind == "flat":
        payload = corpus if spec.reduce is None else get(".index.payload")
    else:
        cls = _PAYLOADS[spec.kind]
        payload = cls(**{f: get(f".index.payload.{f}") for f in cls._fields})
    return EngineState(corpus=corpus, proj=proj,
                       index=Index(spec.kind, payload))


def stream_from_arrays(arrays: Mapping[str, np.ndarray],
                       spec: Union[str, IndexSpec],
                       device: DeviceLike = None
                       ) -> Tuple[StreamStore, FrozenParams]:
    """The port's (StreamStore, FrozenParams) for ``spec`` from JAX arrays
    keyed by the ``keystr`` paths of ``{"store": store, "frozen":
    frozen}``; a store field JAX holds as None is None here too."""
    if isinstance(spec, str):
        spec = parse_spec(spec)
    get = _getter(arrays, resolve_device(device))
    store = StreamStore(**{
        f: (get(f"['store'].{f}") if f"['store'].{f}" in arrays else None)
        for f in StreamStore._fields})
    q = "['frozen'].quant.payload"
    if spec.kind == "flat":
        quant = None
    elif spec.kind == "ivf":
        quant = get(q)
    else:
        cls = _QUANTS[spec.kind]
        quant = cls(**{f: get(f"{q}.{f}") for f in cls._fields})
    return store, FrozenParams(proj=_reducer(get, spec, "['frozen'].proj"),
                               quant=Index(spec.kind, quant))


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


def _checked(arrays: Mapping[str, np.ndarray], key: str, shape,
             dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    """``arrays[key]`` bit for bit on ``dev``; it must have ``shape`` and
    ``dtype``."""
    if key not in arrays:
        raise KeyError(f"no array under {key}")
    t = _tensor(np.asarray(arrays[key]))
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"{key}: {tuple(t.shape)} {t.dtype}, expected "
                         f"{tuple(shape)} {dtype}")
    return t.to(dev)


def lm_params_from_arrays(arrays: Mapping[str, np.ndarray], cfg: LMConfig,
                          device: DeviceLike = None) -> Params:
    """The port's LM parameters for ``cfg`` from JAX arrays keyed by
    ``jax.tree_util.keystr`` paths, copied bit for bit by
    ``params_from_arrays`` against ``lm_init_params(cfg)`` drawn on the
    CPU: each must have the shape and dtype ``cfg`` gives it (an MoE
    router is f32 whatever ``cfg.dtype`` is)."""
    return params_from_arrays(arrays, lm_init_params(cfg, 0, device="cpu"),
                              device)


def gin_params_from_arrays(arrays: Mapping[str, np.ndarray], cfg: GINConfig,
                           device: DeviceLike = None) -> Params:
    """The port's GIN parameters for ``cfg`` from JAX's
    (``repro.models.gnn.gin_init_params``) keyed by ``keystr`` paths,
    copied bit for bit by ``params_from_arrays`` against
    ``gin_init_params(cfg)`` drawn on the CPU: every layer's
    ``['mlp']['w1' | 'b1' | 'w2' | 'b2']`` and ``['eps']``, and
    ``['head']``, each of its shape and dtype."""
    return params_from_arrays(arrays, gin_init_params(cfg, 0, device="cpu"),
                              device)


def params_from_arrays(arrays: Mapping[str, np.ndarray], template: Any,
                       device: DeviceLike = None) -> Any:
    """A tree shaped like ``template`` (the port's own parameters of the
    same model and configuration, e.g. ``recsys.sasrec_init(cfg, 0,
    device="cpu")``) holding ``arrays`` keyed by the ``keystr`` path of
    each leaf, copied bit for bit; each must have its template leaf's
    shape and dtype, and every array must be used."""
    dev = resolve_device(device)
    leaves = keyed_leaves(template)
    extra = sorted(set(arrays) - {key for key, _ in leaves})
    if extra:
        raise KeyError(f"arrays with no place in the template: {extra}")
    return tree_unflatten(template, [
        _checked(arrays, key, leaf.shape, leaf.dtype, dev)
        for key, leaf in leaves])


def opt_state_from_arrays(arrays: Mapping[str, np.ndarray], params: Params,
                          device: DeviceLike = None) -> Dict[str, object]:
    """The port's AdamW state beside ``params`` from the JAX state of
    ``init_opt_state`` / ``adamw_update`` keyed by ``keystr`` paths: the
    int32 ``['step']`` and, for each parameter path P, the f32 moments
    ``['m']P`` and ``['v']P`` of that parameter's shape."""
    dev = resolve_device(device)

    def get(key, shape, dtype):
        return _checked(arrays, key, shape, dtype, dev)

    leaves = keyed_leaves(params)

    def moments(name):
        return tree_unflatten(params, [
            get(f"['{name}']{path}", p.shape, torch.float32)
            for path, p in leaves])

    return {"step": get("['step']", (), torch.int32), "m": moments("m"),
            "v": moments("v")}
