"""Expert parallelism of the port (``moe_block(impl="ep")`` under a
("data", "model") mesh) against the JAX package's ``_moe_ep_shardmap``:
4 gloo ranks on a (2, 2) mesh, f32, capacity_factor 1.25 with assignments
dropped. Each rank's output rows within 1e-5 of JAX's, the aux loss
(the mean of the slices' Switch losses over every rank) within 1e-6
relative, the expert ids of each model slice equal, its dropped
assignments the count its capacity gives, and the gradients in x and in
every expert and router block within 1e-5 relative L2 of ``jax.grad``'s.
A batch too small for EP (2 tokens a model rank) takes JAX's
fall-through, ``dispatch`` over the whole batch, on the gathered blocks.

JAX's references come from one subprocess with 8 forced host devices and
an ``AxisType.Auto`` mesh; the ranks are spawned once, beside it.
"""
import os
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.models import moe  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E, K, D, F = 8, 2, 24, 16
CF = 1.25
AUX_W = 0.7                      # the aux loss's weight in the test loss
# "ep": 32 tokens a model rank, capacity 16 (a slice's), drops live;
# "fallback": 2 tokens a model rank, under JAX's 8: dispatch on 8 tokens
CASES = {"ep": (4, 32), "fallback": (2, 4)}
DP, MP = 2, 2
OUT_ATOL = 1e-5
AUX_RTOL = 1e-6
GRAD_REL = 1e-5
LEAVES = ("router", "w_gate", "w_up", "w_down")


def _inputs(case):
    """x (B, S, D) and the loss's cotangent R, seeded. The tokens share a
    direction (as a layer's input does: the attention output), so the
    router favours some experts and a slice's capacity drops
    assignments."""
    b, s = CASES[case]
    rng = np.random.default_rng(b * 100 + s)
    shared = 2.0 * rng.standard_normal(D)
    x = rng.standard_normal((b, s, D)) + shared
    return (x.astype(np.float32),
            rng.standard_normal((b, s, D)).astype(np.float32))


_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, "src")
    sys.path.insert(0, "tests")
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.models import moe as jmoe
    from repro.parallel.context import mesh_context
    import test_torch_moe_ep as T

    mc = jmoe.MoEConfig(n_experts=T.E, top_k=T.K, d_ff=T.F, impl="ep",
                        capacity_factor=T.CF)
    p = jax.tree.map(lambda a: a[0], jmoe.init_moe_params(
        jax.random.key(0), mc, T.D, 1, jnp.float32))
    mesh = jax.make_mesh((T.DP, T.MP), ("data", "model"),
                         devices=jax.devices()[:4],
                         axis_types=(AxisType.Auto,) * 2)
    out = {}
    for case in T.CASES:
        x, r = (jnp.asarray(a) for a in T._inputs(case))

        def loss(x, p):
            y, aux = jmoe.moe_block(x, p, mc)
            return jnp.sum(y * r) / T.DP + T.AUX_W * aux, (y, aux)

        with mesh_context(mesh):
            (_, (y, aux)), (gx, gp) = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(x, p)
        out[f"{case}|y"] = np.asarray(y)
        out[f"{case}|aux"] = np.asarray(aux)
        out[f"{case}|gx"] = np.asarray(gx)
        for n in T.LEAVES:
            out[f"{case}|g|{n}"] = np.asarray(gp[n])
    np.savez(sys.argv[1], **out)
    print("JAX_REFERENCE_OK")
""")


def _jax_params():
    import jax
    import jax.numpy as jnp
    from repro.models import moe as jmoe
    mc = jmoe.MoEConfig(n_experts=E, top_k=K, d_ff=F)
    return {n: np.asarray(a[0]) for n, a in jmoe.init_moe_params(
        jax.random.key(0), mc, D, 1, jnp.float32).items()}


def rank_block(mesh, params):
    """One rank: the EP block on its rows and blocks, what it routed and
    dropped, and its gradients (the parameters' as the mean over the data
    axis), for each case; every rank's results, gathered."""
    import torch.distributed as dist
    from repro_torch.parallel import context as ctx
    from repro_torch.parallel import sharding as sh
    mc = moe.MoEConfig(n_experts=E, top_k=K, d_ff=F, impl="ep",
                       capacity_factor=CF)
    specs = {"router": sh.P(None, "model"), "w_gate": sh.P("model"),
             "w_up": sh.P("model"), "w_down": sh.P("model")}
    seen = {}
    route, tables = moe._route, moe._dispatch_tables

    def recording_route(x2d, router, cfg):
        out = route(x2d, router, cfg)
        seen["ids"] = out[1].detach().numpy()
        return out

    def recording_tables(*a):
        out = tables(*a)
        seen["dropped"] = int((~out[2]).sum())
        return out

    moe._route, moe._dispatch_tables = recording_route, recording_tables
    res = {}
    try:
        for case in CASES:
            x, r = (torch.from_numpy(a) for a in _inputs(case))
            xb = sh.rank_block(mesh, x, sh.P("data")).requires_grad_()
            rb = sh.rank_block(mesh, r, sh.P("data"))
            p = {n: sh.rank_block(mesh, torch.from_numpy(params[n]),
                                  specs[n]).requires_grad_()
                 for n in LEAVES}
            with ctx.mesh_context(mesh):
                y, aux = moe.moe_block(xb, p, mc)
                loss = torch.sum(y * rb) + AUX_W * aux
                grads = torch.autograd.grad(loss, [xb] + [p[n] for n in
                                                          LEAVES])
            gp = {n: ctx.all_reduce_sum(mesh, g, "data") / DP
                  for n, g in zip(LEAVES, grads[1:])}
            res[case] = {"y": y.detach().numpy(), "aux": float(aux),
                         "ids": seen["ids"], "dropped": seen["dropped"],
                         "gx": grads[0].numpy(),
                         "gp": {n: g.numpy() for n, g in gp.items()}}
    finally:
        moe._route, moe._dispatch_tables = route, tables
    every = [None] * mesh.size
    dist.all_gather_object(every, res)
    return every


@pytest.fixture(scope="module")
def runs():
    from repro_torch.launch.mesh import run_ranks
    params = _jax_params()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ref.npz")
        proc = subprocess.Popen(
            [sys.executable, "-c", _SCRIPT, path], cwd=ROOT,
            env=dict(os.environ, JAX_PLATFORMS="cpu"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            got = run_ranks(rank_block, (DP, MP), (params,), device="cpu",
                            axis=("data", "model"))
            stdout, stderr = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        assert "JAX_REFERENCE_OK" in stdout, stderr[-3000:]
        with np.load(path) as f:
            ref = {k: f[k] for k in f.files}
    return ref, got, params


def _rows(case, d):
    b = CASES[case][0] // DP
    return slice(d * b, (d + 1) * b)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("case", list(CASES))
def test_ep_output_matches_jax(runs, case):
    """Each rank's rows within 1e-5 of JAX's; the model ranks of a data
    rank hold the same rows."""
    ref, got, _ = runs
    for rank, res in enumerate(got):
        d = rank // MP
        np.testing.assert_allclose(res[case]["y"],
                                   ref[f"{case}|y"][_rows(case, d)],
                                   atol=OUT_ATOL, rtol=0)
        np.testing.assert_array_equal(res[case]["y"],
                                      got[d * MP][case]["y"])


@pytest.mark.parametrize("case", list(CASES))
def test_ep_aux_matches_jax(runs, case):
    """EP's aux is the mean of the slices' Switch losses over every rank
    (JAX's pmean), the fall-through's the whole batch's."""
    ref, got, _ = runs
    for res in got:
        np.testing.assert_allclose(res[case]["aux"],
                                   float(ref[f"{case}|aux"]), rtol=AUX_RTOL)


def _slice_tokens(case, rank):
    """The (T, D) tokens rank routes: its model slice of its data rank's
    rows under EP, the whole batch in the fall-through."""
    x = _inputs(case)[0]
    if case == "fallback":
        return x.reshape(-1, D)
    d, m = divmod(rank, MP)
    x2 = x[_rows(case, d)].reshape(-1, D)
    t = x2.shape[0] // MP
    return x2[m * t:(m + 1) * t]


@pytest.mark.parametrize("case", list(CASES))
def test_ep_expert_ids_match_jax(runs, case):
    """Each rank routes its slice with the whole router: the expert ids
    of JAX's ``_route`` on the same tokens."""
    import jax.numpy as jnp
    from repro.models import moe as jmoe
    _, got, params = runs
    mc = jmoe.MoEConfig(n_experts=E, top_k=K, d_ff=F)
    for rank, res in enumerate(got):
        _, ids, _ = jmoe._route(jnp.asarray(_slice_tokens(case, rank)),
                                jnp.asarray(params["router"]), mc)
        np.testing.assert_array_equal(res[case]["ids"], np.asarray(ids))


@pytest.mark.parametrize("case", list(CASES))
def test_ep_drops_at_the_slice_capacity(runs, case):
    """The assignments past capacity are those a count over the slice's
    expert ids gives at the slice's capacity (JAX's per-slice cap: 16 for
    32 tokens, not the whole batch's); the EP case drops some."""
    _, got, _ = runs
    mc = moe.MoEConfig(n_experts=E, top_k=K, d_ff=F, capacity_factor=CF)
    total = 0
    for res in got:
        ids = res[case]["ids"]
        cap = moe.capacity(ids.shape[0], mc)
        counts = np.bincount(ids.ravel(), minlength=E)
        want = int(np.maximum(counts - cap, 0).sum())
        assert res[case]["dropped"] == want
        total += want
    if case == "ep":
        assert moe.capacity(CASES["ep"][0] * CASES["ep"][1] // DP // MP,
                            mc) == 16
        assert total > 0


@pytest.mark.parametrize("leaf", ("x",) + LEAVES)
@pytest.mark.parametrize("case", list(CASES))
def test_ep_gradients_match_jax(runs, case, leaf):
    """Gradients within 1e-5 relative L2 of JAX's: a rank's x gradient is
    its data replica's (DP times JAX's rows, the step's convention), a
    parameter block's the mean over the data axis of the ranks' (the
    router's summed over the model ranks' slices first)."""
    from repro_torch.parallel import sharding as sh
    from repro_torch.parallel.context import Mesh
    ref, got, _ = runs
    specs = {"router": sh.P(None, "model"), "w_gate": sh.P("model"),
             "w_up": sh.P("model"), "w_down": sh.P("model")}
    for rank, res in enumerate(got):
        d = rank // MP
        if leaf == "x":
            g, want = res[case]["gx"], DP * ref[f"{case}|gx"][_rows(case, d)]
        else:
            rec = Mesh("data", DP * MP, rank, None, "gloo",
                       torch.device("cpu"), names=("data", "model"),
                       dims=(DP, MP))
            g = res[case]["gp"][leaf]
            want = sh.rank_block(rec, torch.from_numpy(
                ref[f"{case}|g|{leaf}"]), specs[leaf]).numpy()
        assert g.shape == want.shape
        assert _rel(g, want) <= GRAD_REL, (rank, _rel(g, want))


def test_ep_slice_is_dispatch_at_its_capacity(runs):
    """The one-process oracle: ``dispatch`` on each model slice with the
    slice's capacity gives the EP ranks' rows (within 1e-5: the experts
    run on other batch shapes)."""
    _, got, params = runs
    mc = moe.MoEConfig(n_experts=E, top_k=K, d_ff=F, impl="dispatch",
                       capacity_factor=CF)
    p = {n: torch.from_numpy(a.copy()) for n, a in params.items()}
    for rank, res in enumerate(got):
        d, m = divmod(rank, MP)
        xs = torch.from_numpy(_slice_tokens("ep", rank))
        y, _ = moe.moe_block(xs[None], p, mc)
        t = xs.shape[0]
        np.testing.assert_allclose(
            res["ep"]["y"].reshape(-1, D)[m * t:(m + 1) * t],
            y[0].numpy(), atol=OUT_ATOL, rtol=0)
