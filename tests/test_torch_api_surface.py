"""The port's public surface (twin of tests/test_api_surface.py): every
name ``repro_torch.search.__all__`` exports resolves and is documented,
the composable entry points are exported, and every module of
``repro_torch`` exports at least what its JAX twin's ``__all__`` does,
less the Pallas kernels' entry points (the port's CUDA kernels are their
own wrappers) and the one rename ``jax_profile -> torch_profile``; the
lists of what a ROADMAP.md item still owes (``_ITEM_13``,
``_MODULES_OWED``) are empty since the dry-run tools and the ArchSpec
builders landed, and a name put back on them fails while the port exports
it. Then the public functions the
surface gained in the same slice, each against its JAX twin:
``ivf_search``, ``ivfpq_search``, ``as_serve_config``,
``dequantize_lut``, ``mu_b_fast`` and ``mu_b_fast_value_and_grad``."""
import importlib
import importlib.util
import inspect
import pkgutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro_torch.search as search  # noqa: E402

# JAX module -> names its __all__ has that the port does not export yet
# (item 13's ArchSpec builders, the last, landed with the dry-run tools)
_ITEM_13 = {}
# the Pallas kernels' entry points: the port launches CUDA kernels
# through its own wrappers (knn_topk, pairwise_stats, pq_adc_topk,
# pq_adc_gather_topk, which it does export)
_PALLAS = {
    "repro.kernels.knn_topk": {"knn_topk_pallas"},
    "repro.kernels.mpad_pairwise": {"pairwise_stats_pallas"},
    "repro.kernels.pq_adc": {"pq_adc_topk_pallas",
                             "pq_adc_gather_topk_pallas"},
}
_RENAMED = {"repro.search": {"jax_profile": "torch_profile"},
            "repro.search.tracing": {"jax_profile": "torch_profile"}}
# JAX modules with no port twin yet, and the item that ports each (none)
_MODULES_OWED = {}


def test_all_names_resolve():
    assert search.__all__, "repro_torch.search must declare __all__"
    for name in search.__all__:
        assert hasattr(search, name), f"__all__ exports missing {name!r}"
    assert len(set(search.__all__)) == len(search.__all__)


def test_all_public_objects_are_documented():
    """Every exported class and function carries a docstring."""
    undocumented = []
    for name in search.__all__:
        obj = getattr(search, name)
        if inspect.isclass(obj) or inspect.isfunction(obj):
            if not (inspect.getdoc(obj) or "").strip():
                undocumented.append(name)
    assert not undocumented, f"undocumented public API: {undocumented}"


def test_composable_api_entry_points_exported():
    for name in ("IndexSpec", "Reduce", "Coarse", "Code", "Rerank",
                 "parse_spec", "format_spec", "spec_from_config",
                 "config_from_spec", "Index", "IndexOps", "ScanParams",
                 "get_ops", "register_index", "build_engine", "save_engine",
                 "load_engine", "SearchEngine", "ServeConfig",
                 "StreamConfig", "Reducer", "ReducerOps", "register_reducer",
                 "get_reducer_ops", "fit_reducer", "reduce_vectors",
                 "reducer_dim", "REDUCER_KINDS", "EngineMetrics",
                 "MetricsServer", "render_prometheus", "TraceConfig",
                 "Tracer", "deep_trace", "torch_profile", "DurabilityConfig",
                 "Wal", "replay", "catch_up", "seed_follower"):
        assert name in search.__all__, f"{name} missing from __all__"


def test_reducer_registry_covers_kinds():
    """Every reducer kind has its hooks (JAX's ``skeleton`` builds jax
    restore templates; the port's snapshot reader reads params by key)."""
    assert set(search.REDUCER_KINDS) >= {"qpad", "pca", "mlp"}
    for kind in search.REDUCER_KINDS:
        ops = search.get_reducer_ops(kind)
        assert ops.kind == kind
        for hook in ("fit", "transform", "out_dim"):
            assert callable(getattr(ops, hook)), (kind, hook)


def test_registry_covers_index_kinds():
    """Every index kind of the grammar is registered with the hooks the
    single-device and the sharded stacks call."""
    for kind in search.INDEX_KINDS:
        ops = search.get_ops(kind)
        assert ops.kind == kind
        for hook in ("build", "scan", "stream_scan", "store_parts",
                     "encode_delta", "rebuild", "local_scan",
                     "shard_payload", "payload_specs",
                     "stream_base_payload"):
            assert callable(getattr(ops, hook)), (kind, hook)


def test_exports_match_module_all():
    """Names of the submodules' __all__ that the package re-exports stay
    in sync (no silently dropped public symbol)."""
    from repro_torch.search import registry, spec
    for name in spec.__all__:
        assert name in search.__all__, f"spec.{name} not re-exported"
    for name in ("Index", "IndexOps", "ScanParams", "get_ops",
                 "register_index"):
        assert name in registry.__all__


def _jax_modules():
    repro = pytest.importorskip("repro")
    pytest.importorskip("jax")
    names = [repro.__name__]
    names += [m.name for m in pkgutil.walk_packages(repro.__path__,
                                                    "repro.")]
    return names


def _has_twin(tname):
    try:
        return importlib.util.find_spec(tname) is not None
    except ModuleNotFoundError:          # its parent package is missing
        return False


def test_every_module_covers_its_jax_twin():
    """The pin: each ``repro_torch`` module's ``__all__`` holds its JAX
    twin's, less the named lists above; a JAX module with no twin is
    owed by a named item."""
    checked = 0
    for name in _jax_modules():
        tname = "repro_torch" + name[len("repro"):]
        if not _has_twin(tname):
            parts = name.split(".")
            owner = next((_MODULES_OWED[p] for p in (
                ".".join(parts[:i]) for i in range(len(parts), 1, -1))
                if p in _MODULES_OWED), None)
            # the Pallas kernel bodies (kernels.*.kernel) have no twin: the
            # CUDA sources under csrc/ take their place
            assert owner is not None or name.endswith(".kernel"), name
            continue
        jall = getattr(importlib.import_module(name), "__all__", None)
        tmod = importlib.import_module(tname)
        if jall is None:
            continue
        tall = set(getattr(tmod, "__all__", ()))
        owed = _ITEM_13.get(name, set()) | _PALLAS.get(name, set())
        renamed = _RENAMED.get(name, {})
        for jname in jall:
            if jname in owed:
                assert jname not in tall, f"{tname}.{jname} landed: unlist"
                continue
            want = renamed.get(jname, jname)
            assert want in tall, f"{tname}.__all__ lacks {want!r}"
            assert hasattr(tmod, want), f"{tname}.{want} does not resolve"
        checked += 1
    assert checked >= 40


def test_renamed_and_owed_lists_name_real_jax_exports():
    """The exclusions name what JAX really exports (a stale entry would
    hide a gap)."""
    for table in (_ITEM_13, _PALLAS, _RENAMED):
        for name, names in table.items():
            jall = set(importlib.import_module(name).__all__)
            assert set(names) <= jall, (name, set(names) - jall)


def test_core_exports_the_fast_objective():
    import repro_torch.core as core
    for name in ("find_quantile_threshold", "threshold_stats",
                 "phi_fast_value_and_grad", "mu_b_fast",
                 "mu_b_fast_value_and_grad"):
        assert name in core.__all__ and callable(getattr(core, name))


# --- the functions the surface gained, against JAX's ------------------------

N, DIM, K = 600, 32, 10


def _data(seed=0, n=N, d=DIM):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(12, d)) * 2
    lab = rng.integers(0, 12, n)
    return (centers[lab] + 0.3 * rng.normal(size=(n, d))).astype(np.float32)


def _state_arrays(state):
    import jax
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


@pytest.mark.parametrize("spec,lut", [("ivf12x4", None),
                                      ("ivf12x4>pq8x64>rr40", "f32"),
                                      ("ivf12x4>pq8x64:i8>rr40", "int8")])
def test_ivf_and_ivfpq_search_return_jax_ids(spec, lut):
    from repro.search import build_engine as jax_build_engine
    from repro.search import ivf_search as jax_ivf_search
    from repro.search import ivfpq_search as jax_ivfpq_search
    from repro_torch.bridge import state_from_arrays
    jeng = jax_build_engine(_data(), spec)
    state = state_from_arrays(_state_arrays(jeng.state), spec, device="cpu")
    q = _data(seed=3, n=16)
    if lut is None:
        dj, ij = jax_ivf_search(jeng.state.index.payload, q, K, nprobe=4)
        dt, it = search.ivf_search(state.index.payload, torch.from_numpy(q),
                                   K, nprobe=4)
    else:
        dj, ij = jax_ivfpq_search(jeng.state.index.payload, q, K, nprobe=4,
                                  lut_dtype=lut)
        dt, it = search.ivfpq_search(state.index.payload,
                                     torch.from_numpy(q), K, nprobe=4,
                                     lut_dtype=lut)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5,
                               atol=1e-5)


def test_as_serve_config_matches_jax():
    from repro.search.serve import as_serve_config as jax_as_serve_config
    for cfg in ("qpad32>ivf64x8>pq8x256:i8", "flat",
                search.parse_spec("pca8>ivf12x4>rr40")):
        jcfg = jax_as_serve_config(cfg if isinstance(cfg, str)
                                   else search.format_spec(cfg))
        tcfg = search.as_serve_config(cfg)
        assert search.format_spec(tcfg.to_spec()) == search.format_spec(
            search.parse_spec(cfg) if isinstance(cfg, str) else cfg)
        for f in ("target_dim", "reducer", "rerank", "index", "nlist",
                  "nprobe", "pq_subspaces", "pq_centroids", "lut_dtype",
                  "pq_backend"):
            assert getattr(tcfg, f) == getattr(jcfg, f), f
    same = search.ServeConfig(index="flat")
    assert search.as_serve_config(same) is same
    with pytest.raises(TypeError, match="spec string"):
        search.as_serve_config(42)


@pytest.mark.parametrize("lut_dtype", ["f32", "bf16", "int8"])
def test_dequantize_lut_matches_jax(lut_dtype):
    from repro.kernels.pq_adc.lut import dequantize_lut as jax_dequantize
    from repro.kernels.pq_adc.lut import quantize_lut as jax_quantize
    from repro_torch.kernels.pq_adc import dequantize_lut, quantize_lut
    rng = np.random.default_rng(1)
    tables = (rng.normal(size=(5, 8, 64)) * 3).astype(np.float32)
    tq, ts = quantize_lut(torch.from_numpy(tables), lut_dtype)
    jq, js = jax_quantize(tables, lut_dtype)
    got = dequantize_lut(tq, ts)
    want = np.asarray(jax_dequantize(jq, js))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    bound = {"f32": 0.0, "bf16": 2.0 ** -8 * 12, "int8": float(ts.max())}
    assert float((got - torch.from_numpy(tables)).abs().max()) <= (
        bound[lut_dtype] + 1e-6)


@pytest.mark.parametrize("n,b", [(64, 80.0), (300, 5.0), (257, 50.0)])
def test_mu_b_fast_matches_jax_value_and_grad(n, b):
    """The value and the tangent gradient against JAX's
    ``mu_b_fast_value_and_grad``; the autograd Function's gradients
    against ``jax.grad`` of JAX's custom-VJP ``mu_b_fast`` in w and x."""
    import jax
    from repro.core import fast_objective as jfo
    from repro_torch.core import mu_b_fast, mu_b_fast_value_and_grad
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, 12)).astype(np.float32)
    w = rng.normal(size=12).astype(np.float32)
    vj, gj = jfo.mu_b_fast_value_and_grad(w, x, b=b)
    vt, gt = mu_b_fast_value_and_grad(torch.from_numpy(w),
                                      torch.from_numpy(x), b=b)
    np.testing.assert_allclose(float(vt), float(vj), rtol=1e-5)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-4,
                               atol=1e-5)
    gwj, gxj = jax.grad(lambda w_, x_: jfo.mu_b_fast(w_, x_, b=b),
                        argnums=(0, 1))(w, x)
    wt = torch.from_numpy(w).requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    value = mu_b_fast(wt, xt, b=b)
    np.testing.assert_allclose(float(value.detach()), float(vj), rtol=1e-5)
    (3.0 * value).backward()
    np.testing.assert_allclose(wt.grad.numpy(), 3.0 * np.asarray(gwj),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), 3.0 * np.asarray(gxj),
                               rtol=1e-4, atol=1e-5)
