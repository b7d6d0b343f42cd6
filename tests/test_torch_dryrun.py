"""The dry-run tools and the rank programs they trace.

* F8: a tree gathered from blocks holds values: an in-place
  ``sharded_adamw_update`` on the blocks (a (1, 2) gloo mesh, a leaf
  under ``P()`` and one under ``P(None, "model")``) changes no leaf of it,
  nor of the tree the blocks were cut from.
* The fake world against a real one: at SMOKE sizes on a (2, 2) mesh the
  dry-run's trace of ranks 0 and 3 (``launch.dryrun.run_cell`` on fake
  CPU tensors in a fake world, in a subprocess) reads the same collective
  bytes and calls by kind, FLOPs, unfused bytes, argument bytes and kernel
  launches as a real gloo run of the same rank program (``run_ranks``),
  for an LM, a MoE LM (EP), the MoE LM's prefill and decode (its 8,192
  slots split over "model": the merge's ``all_reduce_max`` and sums),
  sasrec, two-tower and gin (full graph and molecules). On meta tensors
  (the card's routes) the LM and GIN traces count the kernels' launches a
  step.
* The new rank programs against one process: at (1, 1) the sharded
  recsys / GIN train steps are bit-equal to ``make_train_step``; at
  (2, 2) the loss within ``LOSS_RTOL`` and step 0's gradients within
  ``GRAD_REL`` (f32, summed in other orders); the serve programs' ids
  equal one process's.
* The CLIs: ``launch.dryrun``'s statuses (ok, skipped: a decode cell
  traced through its rank program) and its cache; ``launch.dryrun_mpad``
  on an 8-rank fake world at N 8192 x 64:
  a rank's all-gather of its 1,024 projections (4,096 B) and all-reduce
  of the 64-gradient (256 B), the closed form.

Each fake world runs in a process of its own.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch._tree import keyed_leaves, tree_map  # noqa: E402
from repro_torch.parallel import sharding as sh  # noqa: E402
from repro_torch.parallel.context import Mesh  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
# f32 on every rank and in one process, summed in other orders
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
RANKS = (0, 3)

# case -> the cells it traces
CASES = {"lm": ("train_4k",), "moe": ("train_4k",),
         "lm_serve": ("prefill_32k", "decode_32k"),
         "sasrec": ("train_batch", "serve_p99"),
         "twotower": ("train_batch", "serve_p99", "retrieval_cand"),
         "gin_full": ("full_graph_sm",), "gin_mol": ("molecule",)}


# --- the cases: small configurations through the family builders ----------

def _case(name):
    """(arch, real-argument maker, one-process loss or serve fn by cell)."""
    from repro_torch.configs import LM_CONFIGS, gnn_family, lm_family, \
        recsys_family
    from repro_torch.models import gnn, recsys as rs
    from repro_torch.models import transformer as tf
    if name == "lm_serve":
        # the decode cell's 8,192 slots split on the sequence over "model"
        # (lm_cache_specs' threshold): the merged attention's collectives
        cfg = LM_CONFIGS["granite-moe-1b-a400m"][1]
        arch = lm_family.make_lm_arch(
            "granite-moe-1b-a400m", cfg, cfg, long_ok=False,
            shapes={"prefill_32k": dict(kind="prefill", batch=4, seq=32),
                    "decode_32k": dict(kind="decode", batch=4, seq=8192)})
        return (arch, lambda: tf.lm_init_params(cfg, 0, "cpu"),
                {"tokens": cfg.vocab}, {})
    if name in ("lm", "moe"):
        arch_name = "tinyllama-1.1b" if name == "lm" else \
            "granite-moe-1b-a400m"
        cfg = LM_CONFIGS[arch_name][1]
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, impl="ep",
                capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
        arch = lm_family.make_lm_arch(
            arch_name, cfg, cfg, long_ok=False,
            shapes={"train_4k": dict(kind="train", batch=4, seq=32)})
        flash = dataclasses.replace(cfg, attn_impl="flash")
        return (arch, lambda: tf.lm_init_params(cfg, 0, "cpu"),
                {"tokens": cfg.vocab, "labels": cfg.vocab},
                {"train_4k": lambda p, b: tf.lm_train_forward(p, flash, b)})
    if name == "sasrec":
        cfg = rs.SASRecConfig(name="sasrec-t", n_items=64, embed_dim=16,
                              seq_len=8)
        shapes = {"train_batch": dict(kind="train", batch=8),
                  "serve_p99": dict(kind="serve", batch=8)}
        arch = recsys_family.make_sasrec_arch(cfg, shapes=shapes)
        return (arch, lambda: rs.sasrec_init(cfg, 0, "cpu"),
                dict.fromkeys(("seq", "pos", "neg"), cfg.n_items),
                {"train_batch": lambda p, b: rs.sasrec_loss(p, cfg, b),
                 "serve_p99": lambda p, b: rs.sasrec_serve_topk(
                     p, cfg, b["seq"], k=100)})
    if name == "twotower":
        cfg = rs.TwoTowerConfig(name="tt-t", n_users=64, n_items=64,
                                n_user_feats=3, field_dim=8, embed_dim=16,
                                tower_dims=(16, 16), n_negatives=8)
        shapes = {"train_batch": dict(kind="train", batch=8),
                  "serve_p99": dict(kind="serve", batch=8),
                  "retrieval_cand": dict(kind="serve", batch=1,
                                         n_candidates=64)}
        arch = recsys_family.make_twotower_arch(cfg, mpad_dim=4, rerank=12,
                                                shapes=shapes)

        def pairwise(p, b):
            u = rs.twotower_user(p, cfg, b["user_ids"], b["hist_ids"])
            return torch.sum(u * rs.twotower_item(p, cfg, b["item_ids"]),
                             dim=-1)

        return (arch, lambda: rs.twotower_init(cfg, 0, "cpu"),
                {"user_ids": cfg.n_users, "hist_ids": cfg.n_items,
                 "pos_items": cfg.n_items, "neg_items": cfg.n_items,
                 "item_ids": cfg.n_items},
                {"train_batch": lambda p, b: rs.twotower_loss(p, cfg, b),
                 "serve_p99": pairwise,
                 "retrieval_cand": lambda p, b: rs.twotower_retrieve(
                     p, cfg, b, k=100, reducer=(b["red_matrix"],
                                                b["red_mean"]),
                     rerank=12)})
    base = gnn.GINConfig(name="gin-t", n_layers=3, d_hidden=8)
    shapes = ({"full_graph_sm": dict(regime="full", n_nodes=24, n_edges=60,
                                      d_feat=8, n_classes=3)}
              if name == "gin_full" else
              {"molecule": dict(regime="mol", n_graphs=8, n_nodes=5,
                                d_feat=8, n_classes=2)})
    arch = gnn_family.make_gin_arch("gin-tu", base, shapes=shapes)
    sname = next(iter(shapes))
    c = gnn_family.shape_config(sname, base, shapes)
    loss = gnn.gin_full_loss if name == "gin_full" else gnn.gin_mol_loss
    return (arch, lambda: gnn.gin_init_params(c, 0, "cpu"),
            {"edge_src": 24, "edge_dst": 24, "labels": 3 if
             name == "gin_full" else 2},
            {sname: lambda p, b: loss(p, c, b)})


def _real_args(name, sname, seed=0):
    """The cell's global arguments with values: the case's init, f32
    zero moments, a seeded batch (ids in range, masks and labels as the
    family reads them)."""
    from repro_torch.optim import init_opt_state
    arch, init, highs, _ = _case(name)
    shapes = arch.abstract_args(sname, "meta")
    rng = np.random.default_rng(seed)
    params = init()
    if arch.family == "lm" and arch.shapes[sname].kind != "train":
        # a prompt or a decode token, the empty cache (pos -1) and the
        # position half-way (a decode attends to its own slot)
        cache = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype),
                         shapes[-1])
        for run in cache:
            run["pos"].fill_(-1)
        toks = torch.from_numpy(rng.integers(
            0, highs["tokens"], tuple(shapes[1].shape))).to(torch.int32)
        if arch.shapes[sname].kind == "prefill":
            return (params, toks, cache)
        cur = torch.tensor(cache[0]["pos"].shape[0] // 2, dtype=torch.int32)
        return (params, toks, cur, cache)
    batch = {}
    for key, leaf in shapes[-1].items():
        shape, dt = tuple(leaf.shape), leaf.dtype
        if key in highs:
            v = rng.integers(0, highs[key], shape)
        elif key in ("edge_mask",):
            v = (np.arange(shape[0]) < 60).astype(np.float32)
        elif key in ("label", "adj", "label_mask"):
            v = (rng.random(shape) > 0.3).astype(np.float32)
        elif key == "neg_logq":
            v = np.full(shape, -np.log(64.0), np.float32)
        elif not dt.is_floating_point:
            v = rng.integers(-100, 100, shape)
        else:
            v = rng.standard_normal(shape)
        batch[key] = torch.from_numpy(np.asarray(v)).to(dt)
    if len(shapes) == 3:
        return (params, init_opt_state(params), batch)
    return (params, batch)


def _readings(res):
    from repro_torch.parallel.context import COLLECTIVE_KINDS
    return {"flops": res["dot_flops"], "bytes": res["bytes"],
            "coll": {k: res[f"coll_{k}"] for k in COLLECTIVE_KINDS},
            "calls": dict(res["coll_counts"]),
            "argument_bytes": res["argument_bytes"],
            "launches": res["launches"]}


# --- rank functions (module level: the spawned ranks import this file) -----

def _rank_cases(mesh):
    """Every case's cells on this rank: the readings of one call of the
    rank program, the train cells' loss and step-0 gradients (gathered),
    the serve cells' outputs (gathered); all ranks' readings to rank 0."""
    import torch.distributed as dist

    from repro_torch.launch.step_analysis import analyze_step
    from repro_torch.parallel import step as pstep
    out = {}
    for name, cells in CASES.items():
        arch = _case(name)[0]
        for sname in cells:
            args = _real_args(name, sname)
            blocks = sh.shard_tree(mesh, args, arch.arg_specs(sname, mesh))
            step = arch.step_fn(sname, mesh)
            seen = {}
            update = pstep.sharded_adamw_update

            def recording(m, grads, *a, **kw):
                # the step's own tensors (the update makes new ones from
                # them): a copy here would add to the step's readings
                seen["grads"] = grads
                return update(m, grads, *a, **kw)

            pstep.sharded_adamw_update = recording
            try:
                res = analyze_step(step, blocks, mesh)
            finally:
                pstep.sharded_adamw_update = update
            got = {"readings": _readings(res)}
            if "grads" in seen:
                pspec = arch.arg_specs(sname, mesh)[0]
                got["loss"] = float(res["out"][0])
                got["grads"] = {k: v.numpy() for k, v in keyed_leaves(
                    sh.gather_tree(mesh, seen["grads"], pspec))}
            else:
                full = sh.gather_tree(mesh, res["out"],
                                      arch.out_specs(sname, mesh))
                got["out"] = [t.numpy() for _, t in keyed_leaves(full)]
            out[(name, sname)] = got
    every = [None] * mesh.size
    dist.all_gather_object(every, {k: v["readings"] for k, v in out.items()})
    return {"rank0": out, "readings": every}


def _rank_f8(mesh):
    """F8's probe: gather, step in place on the blocks, compare."""
    from repro_torch.optim import AdamWConfig, init_zero_opt_state, \
        sharded_adamw_update
    full = {"whole": torch.arange(3.0), "split": torch.arange(8.0).reshape(
        2, 4)}
    specs = {"whole": sh.P(), "split": sh.P(None, "model")}
    kept = tree_map(torch.clone, full)
    blocks = sh.shard_tree(mesh, full, specs)
    gathered = sh.gather_tree(mesh, blocks, specs)
    before = tree_map(torch.clone, gathered)
    ospec = sh.opt_specs(specs)
    opt = init_zero_opt_state(mesh, blocks, specs, ospec)
    grads = tree_map(torch.ones_like, blocks)
    sharded_adamw_update(mesh, grads, opt, blocks, AdamWConfig(
        lr=0.5, warmup_steps=0), specs, ospec)
    return {k: {"gathered_kept": bool(torch.equal(gathered[k], before[k])),
                "tree_kept": bool(torch.equal(full[k], kept[k])),
                "blocks_moved": not torch.equal(
                    blocks[k], sh.rank_block(mesh, kept[k], specs[k]))}
            for k in full}


# --- the fake traces, in a process of their own ----------------------------

def _fake_main():
    """Print the fake traces' readings (JSON): every case's cells at ranks
    RANKS on fake CPU tensors, and the LM / GIN launches on meta ones."""
    from repro_torch.launch.dryrun import run_cell
    out = {}
    for name, cells in CASES.items():
        arch = _case(name)[0]
        for sname in cells:
            for rank in RANKS:
                rec = run_cell(arch.name, sname, (2, 2), None, rank, "cpu",
                               arch=arch, verbose=False)
                assert rec["status"] == "ok", rec.get("traceback")
                out[f"{name}|{sname}|{rank}|cpu"] = rec
        if name in ("lm", "moe", "lm_serve", "gin_full"):
            rec = run_cell(arch.name, cells[0], (2, 2), None, 0, "meta",
                           arch=arch, verbose=False)
            assert rec["status"] == "ok", rec.get("traceback")
            out[f"{name}|{cells[0]}|0|meta"] = rec
    print("FAKE_JSON " + json.dumps(out))


def _run(code, timeout=600):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


@pytest.fixture(scope="module")
def fake():
    stdout = _run(f"import sys; sys.path.insert(0, {HERE!r}); "
                  "import test_torch_dryrun as t; t._fake_main()")
    line = next(ln for ln in stdout.splitlines()
                if ln.startswith("FAKE_JSON "))
    return json.loads(line[len("FAKE_JSON "):])


@pytest.fixture(scope="module")
def real():
    from repro_torch.launch.mesh import run_ranks
    return run_ranks(_rank_cases, (2, 2), (), device="cpu",
                     axis=("data", "model"))


# --- F8 ---------------------------------------------------------------------

def test_f8_gathered_tree_holds_values_across_an_in_place_step():
    from repro_torch.launch.mesh import run_ranks
    got = run_ranks(_rank_f8, (1, 2), (), device="cpu",
                    axis=("data", "model"))
    for key, r in got.items():
        assert r["blocks_moved"], key
        assert r["gathered_kept"], (key, "the gathered tree moved")
        assert r["tree_kept"], (key, "the tree the blocks came from moved")


# --- the fake world against a real one ---------------------------------------

@pytest.mark.parametrize("name,sname", [(n, s) for n, cells in CASES.items()
                                        for s in cells])
def test_fake_trace_equals_a_real_gloo_run(fake, real, name, sname):
    for rank in RANKS:
        want = real["readings"][rank][(name, sname)]
        rec = fake[f"{name}|{sname}|{rank}|cpu"]
        got = {"flops": rec["flops"], "bytes": rec["bytes_accessed"],
               "coll": {k: v for k, v in rec["collectives"].items()
                        if k not in ("total", "counts")},
               "calls": rec["collectives"]["counts"],
               "argument_bytes": rec["memory"]["argument_size_in_bytes"],
               "launches": rec["launches"]}
        assert got == want, (rank, got, want)
        assert rec["collectives"]["total"] == sum(want["coll"].values())
    if name in ("lm", "moe", "lm_serve", "sasrec", "twotower", "gin_full"):
        # the split tables, experts, edges or cache move bytes between ranks
        assert sum(want["coll"].values()) > 0
    if sname == "decode_32k":
        # a layer's merge over "model": its maximum, then its sums
        n_layers = _case(name)[0].abstract_args(sname, "meta")[-1][0][
            "k"].shape[0]
        assert want["calls"]["all-reduce"] == 2 * n_layers, want


def test_fake_traces_on_the_card_route_count_the_kernels(fake):
    from repro_torch.configs import LM_CONFIGS
    for name, arch_name in (("lm", "tinyllama-1.1b"),
                            ("moe", "granite-moe-1b-a400m")):
        cfg = LM_CONFIGS[arch_name][1]
        rec = fake[f"{name}|train_4k|0|meta"]
        # forward and remat recompute of every layer; one K6 a CE chunk
        assert rec["launches"]["flash_attention_fwd"] == 2 * cfg.n_layers
        assert rec["launches"]["fused_ce_fwd"] == 32 // cfg.seq_chunk
        assert rec["launches"]["flash_attention_fwd_by_route"][
            "simt_f32"] == 2 * cfg.n_layers
    rec = fake["lm_serve|prefill_32k|0|meta"]
    n = LM_CONFIGS["granite-moe-1b-a400m"][1].n_layers
    # one K5 launch a layer, none on the decode
    assert rec["launches"]["flash_attention_fwd"] == n
    assert rec["launches"]["flash_attention_fwd_by_route"]["simt_f32"] == n
    rec = fake["gin_full|full_graph_sm|0|meta"]
    # 3 layers forward, 2 backward (the features need no gradient)
    assert rec["launches"]["csr_gather_sum_by_order"] == {"dst": 3, "src": 2}
    cpu = fake["gin_full|full_graph_sm|0|cpu"]
    assert cpu["launches"]["csr_gather_sum"] == 0
    # the kernels' formulas stand in for the plain ops' products
    assert rec["flops"] != cpu["flops"]


def test_peak_is_the_high_water_mark_of_live_storage():
    """``analyze_step``'s peak on real tensors and under FakeTensorMode:
    the argument, then two live temporaries (a freed one no longer
    counts); the card's model rounds each storage to 512-byte blocks."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.step_analysis import analyze_step

    def fn(x):
        y = x * 2
        z = y + 1
        del y
        return z.sum()

    real = analyze_step(fn, (torch.ones(1000),))
    assert (real["argument_bytes"], real["peak_bytes"]) == (4000, 12000)
    with FakeTensorMode():
        fake = analyze_step(fn, (torch.empty(1000, device="meta"),))
    assert (fake["argument_bytes"], fake["peak_bytes"]) == (4000, 3 * 4096)
    assert fake["bytes"] == real["bytes"] == 2 * 8000 + 4004


# --- the rank programs against one process -----------------------------------

def _one_process_train(name, sname):
    from repro_torch.optim import value_and_grad
    params, _, batch = _real_args(name, sname)
    loss, grads = value_and_grad(_case(name)[3][sname], params, batch)
    return float(loss), {k: v.numpy() for k, v in keyed_leaves(grads)}


# the MoE case is left out: under a mesh EP's aux loss is the mean over the
# model slices of each slice's Switch aux (JAX's shard_map computes it so),
# not the batch's; tests/test_torch_model_sharding.py holds it against JAX
@pytest.mark.parametrize("name,sname", [(n, s) for n, cells in CASES.items()
                                        for s in cells if n != "moe"
                                        and _case(n)[0].shapes[s].kind
                                        == "train"])
def test_sharded_train_step_within_f32_of_one_process(real, name, sname):
    loss, grads = _one_process_train(name, sname)
    got = real["rank0"][(name, sname)]
    np.testing.assert_allclose(got["loss"], loss, rtol=LOSS_RTOL)
    assert set(got["grads"]) == set(grads)
    for k, g in grads.items():
        den = max(float(np.linalg.norm(g)), 1e-30)
        rel = float(np.linalg.norm(got["grads"][k].astype(np.float64) - g))
        assert rel / den <= GRAD_REL or rel <= 1e-7, (k, rel / den)


@pytest.mark.parametrize("name,sname", [(n, s) for n, cells in CASES.items()
                                        for s in cells
                                        if _case(n)[0].shapes[s].kind
                                        == "serve"])
def test_serve_programs_match_one_process(real, name, sname):
    args = _real_args(name, sname)
    want = _case(name)[3][sname](*args)
    want = [t.numpy() for _, t in keyed_leaves(want)]
    got = real["rank0"][(name, sname)]["out"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w.dtype.kind in "iu":
            np.testing.assert_array_equal(g, w)         # ids
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["sasrec", "twotower", "gin_full",
                                  "gin_mol"])
def test_sharded_train_step_at_1x1_is_make_train_step(name):
    """One rank gathers, exchanges and reduces nothing: the sharded step
    runs ``make_train_step``'s operations, bit for bit."""
    from repro_torch.configs import gnn_family, recsys_family
    from repro_torch.optim import make_train_step
    arch, _, _, fns = _case(name)
    sname = next(s for s in arch.shapes if arch.shapes[s].kind == "train")
    mesh = Mesh(axis="data", size=1, rank=0, group=None, backend="gloo",
                device=torch.device("cpu"), names=("data", "model"),
                dims=(1, 1))
    a = _real_args(name, sname)
    blocks = sh.shard_tree(mesh, a, arch.arg_specs(sname, mesh))
    loss, params, opt = arch.step_fn(sname, mesh)(*blocks)
    adam = (gnn_family if name.startswith("gin") else recsys_family)._ADAM
    b = _real_args(name, sname)
    loss_b, params_b, opt_b = make_train_step(fns[sname], adam)(*b)
    assert torch.equal(loss, loss_b)
    for (k, x), (_, y) in zip(keyed_leaves((params, opt)),
                              keyed_leaves((params_b, opt_b))):
        assert torch.equal(x, y), k


# --- the CLIs ---------------------------------------------------------------

def test_dryrun_cli_statuses_and_cache(tmp_path):
    out = str(tmp_path / "dr")
    code = ("from repro_torch.launch import dryrun; import sys; "
            "sys.exit(dryrun.main([{}]))")
    for shape in ("molecule",):
        _run(code.format(f"'--arch', 'gin-tu', '--shape', '{shape}', "
                         f"'--mesh', 'single', '--out', {out!r}"))
    for shape in ("decode_32k", "long_500k"):
        _run(code.format(f"'--arch', 'tinyllama-1.1b', '--shape', "
                         f"'{shape}', '--mesh', 'multi', '--out', {out!r}"))
    recs = {f: json.load(open(os.path.join(out, f)))
            for f in os.listdir(out)}
    mol = recs["pod_16x16.gin-tu.molecule.json"]
    assert mol["status"] == "ok" and mol["n_devices"] == 256
    # 128 graphs over 16 data ranks: 8 a rank; the parameters whole
    assert mol["memory"]["argument_size_in_bytes"] > 8 * 30 * 32 * 4
    assert mol["flops"] > 0 and mol["collectives"]["counts"][
        "all-reduce"] >= 1
    for key in ("cell", "arch", "shape", "mesh", "kind", "model_flops",
                "bytes_accessed", "trace_s", "launches", "step_bytes_top"):
        assert key in mol, key
    for key in ("argument_size_in_bytes", "output_size_in_bytes",
                "temp_size_in_bytes", "peak_memory_in_bytes"):
        assert key in mol["memory"], key
    dec = recs["multipod_2x16x16.tinyllama-1.1b.decode_32k.json"]
    assert dec["status"] == "ok", dec.get("traceback")
    assert dec["memory"]["argument_size_in_bytes"] > 0
    # 128 rows over 32 data ranks, 32,768 slots over 16 model ranks: a
    # layer's merge is two all-reduces over "model"; no K5 in a decode
    assert dec["collectives"]["counts"]["all-reduce"] == 2 * 22
    assert dec["collectives"]["counts"]["all-gather"] > 0
    assert dec["launches"]["flash_attention_fwd"] == 0
    assert recs["multipod_2x16x16.tinyllama-1.1b.long_500k.json"][
        "status"] == "skipped"
    again = _run(code.format(f"'--arch', 'gin-tu', '--shape', 'molecule', "
                             f"'--mesh', 'single', '--out', {out!r}"))
    assert "[cached]" in again


def test_dryrun_mpad_collectives_are_the_closed_form(tmp_path):
    path = str(tmp_path / "mpad.json")
    _run("from repro_torch.launch import dryrun_mpad; dryrun_mpad.main(["
         f"'--ranks', '8', '--n', '8192', '--dim', '64', '--m', '16', "
         f"'--out', {path!r}])")
    rec = json.load(open(path))
    assert rec["coll_bytes_by_kind"]["all-gather"] == 8192 // 8 * 4
    assert rec["coll_bytes_by_kind"]["all-reduce"] == 64 * 4
    assert rec["coll_bytes_dev"] == 4096 + 256
    assert rec["coll_counts"] == {"all-gather": 1, "all-reduce": 1,
                                  "reduce-scatter": 0, "all-to-all": 0,
                                  "collective-permute": 0}
    assert rec["naive_exchange_bytes"] == 8192 * 64 * 4
    assert rec["argument_bytes_dev"] == (64 + 1024 * 64 + 16 * 64 + 16) * 4
    assert rec["dot_flops_dev"] >= 2 * 2 * 1024 * 64
