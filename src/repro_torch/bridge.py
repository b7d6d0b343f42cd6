"""Carry an engine state built by the JAX package across to the port.

``state_from_arrays`` takes the state as a ``{keypath: np.ndarray}`` dict,
keyed by the ``jax.tree_util.keystr`` paths of ``EngineState`` leaves: the
paths ``repro/runtime/checkpoint.py`` writes into a snapshot's ``.npz``
(``['state'].corpus``, ``['state'].proj[0]``, ...) or those of a live
engine's state (``.corpus``, ``.proj.params[0]``, ...). The port cannot
reproduce ``jax.random`` streams, so this is how a test serves the very
arrays the JAX package built.
"""
from __future__ import annotations

from typing import Mapping, Union

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.search.ivfpq import IVFPQIndex
from repro_torch.search.pq import PQIndex
from repro_torch.search.reducers import Reducer
from repro_torch.search.registry import Index, OPQIndex
from repro_torch.search.serve import EngineState
from repro_torch.search.spec import IndexSpec, parse_spec

__all__ = ["state_from_arrays"]

_SNAPSHOT_PREFIX = "['state']"
# the NamedTuple payloads, carried field by field
_PAYLOADS = {"pq": PQIndex, "opq": OPQIndex, "ivfpq": IVFPQIndex}


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
    if spec.reduce is not None:
        if spec.reduce.kind != "qpad":
            raise NotImplementedError(
                f"reducer kind {spec.reduce.kind!r} is not ported yet")
        proj = Reducer("qpad", (get(".proj.params[0]", ".proj[0]"),
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
