"""The port's serving launcher (repro_torch.launch.serve) on the CPU at a
tiny size: its read-only, streaming and persistence flags keep the JAX
launcher's names and defaults, it builds and serves each reducer kind and
the ivf kind with recall against exact search, runs the streaming write
leg (blocking and background compaction), a snapshot round trip and a
durable engine reloaded through recovery under each fsync mode, and the
sharding flags (``--shards`` / ``--mesh host`` / ``--donate``) through
gloo ranks, whose ids and recall equal the unsharded run's. The launchers
draw their queries from different generators, so this compares
behaviour, not numbers."""
import os
import sys

import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes at once: one intra-op thread
# each keeps torch's many small CPU ops from contending for the cores
torch.set_num_threads(1)

from repro_torch.launch import serve  # noqa: E402
from repro_torch.search import load_engine  # noqa: E402

TINY = ["--corpus", "600", "--dim", "32", "--batch", "16", "--batches", "2"]
SHARDING = ("shards", "mesh", "donate")
READ_ONLY = ("corpus", "dim", "spec", "target_dim", "reducer", "batch",
             "batches", "k", "index", "nlist", "nprobe", "pq_subspaces",
             "lut_dtype", "pq_backend", "query_bucket", "stream",
             "delta_capacity", "write_batch", "background_compact",
             "snapshot_dir", "durable", "fsync", "group_commit_ms")


def test_flags_and_defaults_match_the_jax_launcher(monkeypatch):
    from repro.launch import serve as jserve
    monkeypatch.setattr(sys, "argv", ["serve"])
    jargs = vars(jserve._parse_args())
    targs = vars(serve._parse_args([]))
    for name in READ_ONLY:
        assert targs[name] == jargs[name], name
    # every other flag of the JAX launcher is accepted, with its default,
    # except the Pallas interpret switch
    assert set(jargs) - set(targs) == {"interpret"}
    for dest in SHARDING:
        assert targs[dest] == jargs[dest], dest


@pytest.mark.parametrize("argv", [
    ["--spec", "pca8>rr16"],
    ["--target-dim", "4", "--index", "ivfpq", "--nlist", "8", "--nprobe",
     "4", "--pq-subspaces", "4", "--lut-dtype", "int8", "--pq-backend",
     "kernel"],
    ["--spec", "mlp8>ivf8x4>pq4x256:i8>rr32"],
    ["--target-dim", "0"],
])
def test_serves_with_recall(argv, capsys):
    out = serve.main(TINY + argv, device="cpu")
    text = capsys.readouterr().out
    assert "index built" in text and text.count("recall@10=") == 2
    assert set(out) == {"spec", "ms_per_batch", "recall"}
    assert 0.5 <= out["recall"] <= 1.0 and out["ms_per_batch"] > 0
    if argv == ["--target-dim", "0"]:
        assert out["spec"] == "rr40" and out["recall"] == 1.0   # exact


def test_ivf_kind_raises_with_a_pointer(capsys):
    """The ivf kind is ported: ``--index ivf`` and an ivf spec build and
    serve (exact over the probed cells, so recall is high)."""
    out = serve.main(TINY + ["--index", "ivf", "--target-dim", "0",
                             "--nlist", "8", "--nprobe", "4"], device="cpu")
    assert out["spec"] == "ivf8x4>rr40" and out["recall"] >= 0.8
    out = serve.main(TINY + ["--spec", "qpad4>ivf8x2"], device="cpu")
    assert out["spec"].startswith("qpad4>ivf8x2") and out["recall"] >= 0.3
    assert "kind=ivf" in capsys.readouterr().out


STREAM = ["--stream", "--delta-capacity", "64", "--write-batch", "32",
          "--batches", "5"]


@pytest.mark.parametrize("argv", [
    ["--target-dim", "0"],
    ["--spec", "ivf8x4>pq4x256:i8@kernel>rr40"],
    ["--spec", "qpad8>ivf8x4>rr40"],
    ["--spec", "pq4x256:i8>rr40"],
])
def test_stream_flags_run_the_write_leg(argv, capsys):
    """--stream with --delta-capacity and --write-batch: each batch writes
    32 rows before it searches (compacting every second batch), deletes
    an eighth of the previous batch's, and the run ends compacted."""
    out = serve.main(TINY + STREAM + argv, device="cpu")
    text = capsys.readouterr().out
    assert "streaming delta=64" in text and "writes: 160 rows" in text
    st = out["stream"]
    assert st["rows_written"] == 160 and st["grow_count"] == 0
    assert st["compactions"] >= 3 and st["base_rows"] == 600 + 160
    assert out["recall"] >= 0.3


def test_background_compact_flag_folds_off_thread(capsys):
    out = serve.main(TINY + STREAM + ["--background-compact",
                                      "--spec", "ivf8x4>pq4x256>rr40"],
                     device="cpu")
    assert out["stream"]["rows_written"] == 160
    assert out["stream"]["base_rows"] == 760
    assert "final compact" in capsys.readouterr().out


def test_stream_pq_kernel_is_refused():
    """Streaming pq / opq on K2 is refused, as in the JAX package."""
    with pytest.raises(ValueError, match="pq_backend"):
        serve.main(TINY + STREAM + ["--spec", "pq4x256@kernel>rr40"],
                   device="cpu")


def test_snapshot_dir_round_trips(tmp_path, capsys):
    """--snapshot-dir saves the engine and serves the restored one."""
    d = str(tmp_path / "snap")
    out = serve.main(TINY + ["--spec", "ivf8x4>pq4x256:i8>rr40",
                             "--snapshot-dir", d], device="cpu")
    text = capsys.readouterr().out
    assert f"snapshot round-trip via {d}" in text
    assert "serving from the restored engine" in text
    assert os.path.isfile(os.path.join(d, "engine.json"))
    assert out["recall"] >= 0.3 and "wal" not in out


@pytest.mark.parametrize("argv", [
    ["--fsync", "batch"],
    ["--fsync", "always"],
    ["--fsync", "never"],
    ["--fsync", "always", "--group-commit-ms", "2"],
])
def test_durable_flags_log_and_reload(argv, tmp_path, capsys):
    """--stream --durable DIR: the engine is made durable, reloaded from
    DIR through recovery and served; every write of the leg is logged
    under the fsync mode asked for, and a second recovery replays them."""
    d = str(tmp_path / "durable")
    out = serve.main(TINY + STREAM + ["--spec", "ivf8x4>pq4x256:i8>rr40",
                                      "--durable", d] + argv, device="cpu")
    text = capsys.readouterr().out
    assert f"durable via {d}" in text and "recovered engine" in text
    wal = out["wal"]
    mode = argv[1]
    assert f"wal: {wal['records']} records / {wal['bytes']} bytes" in text
    assert wal["fsync"] == mode
    assert wal["group_commit_ms"] == (2.0 if "--group-commit-ms" in argv
                                      else 0.0)
    # 5 upserts of 32 rows, 4 deletes, the compactions and the final one
    assert wal["records"] == 5 + 4 + out["stream"]["compactions"]
    assert wal["last_seq"] == wal["durable_seq"] or mode != "always"
    assert out["stream"]["rows_written"] == 160
    rec = load_engine(d, device="cpu")
    assert rec._replayed == wal["records"]
    assert int(rec.store.n_rows) == out["stream"]["base_rows"]
    rec.close()


def test_runs_on_cuda_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(TINY + ["--spec", "pca8>rr16"])


# --- observability (the five flags of ROADMAP.md's former item 10) ----------

OBSERVABILITY = {"metrics_port": None, "trace_dir": None,
                 "slow_query_ms": None, "deep_trace_every": 0,
                 "recall_every": 0}


def test_observability_flags_match_the_jax_launcher(monkeypatch):
    from repro.launch import serve as jserve
    monkeypatch.setattr(sys, "argv", ["serve"])
    jargs = vars(jserve._parse_args())
    targs = vars(serve._parse_args([]))
    for name, default in OBSERVABILITY.items():
        assert targs[name] == jargs[name] == default, name
    assert not set(OBSERVABILITY) & set(SHARDING)


@pytest.mark.parametrize("argv,lines", [
    (["--slow-query-ms", "0"], ["slow queries (>0.0ms): 2 captured"]),
    (["--deep-trace-every", "1"], ["deep-trace stage p50: probe=",
                                   "(2 samples)"]),
    (["--recall-every", "1"], ["recall estimate: ", "(2 shadow samples)"]),
])
def test_tracing_flags_print_the_jax_lines(argv, lines, capsys):
    out = serve.main(TINY + ["--spec", "ivf8x4>pq4x256:i8>rr40"] + argv,
                     device="cpu")
    text = capsys.readouterr().out
    assert "tracing on (histograms, " in text
    assert "latency: p50=" in text and "over 2 traced searches" in text
    for line in lines:
        assert line in text
    flat = out["metrics"]
    assert flat["latency.queries"] == 2
    if "--recall-every" in argv:
        assert flat["recall.samples"] == 2 and flat["recall.k"] == 10
        assert 0.0 < flat["recall.estimate_at_k"] <= 1.0


def test_trace_dir_flag_writes_a_chrome_trace(tmp_path, capsys):
    import json
    d = str(tmp_path / "traces")
    serve.main(TINY + ["--spec", "pca8>rr16", "--trace-dir", d],
               device="cpu")
    text = capsys.readouterr().out
    path = text.split("trace written: ")[1].split()[0]
    assert os.path.dirname(path) == d
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert [e["name"] for e in events] == ["search", "search"]


def test_metrics_port_serves_the_typed_metrics(tmp_path, capsys):
    """--metrics-port 0 binds an ephemeral port, scrapes mid-traffic and at
    the end; on a durable streaming engine the scrape holds wal.*."""
    d = str(tmp_path / "durable")
    out = serve.main(TINY + STREAM + ["--spec", "ivf8x4>pq4x256:i8>rr40",
                                      "--durable", d, "--metrics-port", "0"],
                     device="cpu")
    text = capsys.readouterr().out
    assert "metrics at http://127.0.0.1:" in text
    assert "mid-traffic scrape: " in text and "sample scrape" in text
    scrape = out["scrape"]
    assert scrape[-1].startswith("qpad_engine_info{")
    assert "# TYPE qpad_latency_search_seconds histogram" in scrape
    assert f"qpad_wal_records {out['wal']['records']}" in scrape
    assert out["metrics"]["latency.queries"] == 5


SHARDED = TINY + ["--index", "ivfpq", "--nlist", "16", "--nprobe", "4",
                  "--target-dim", "8"]
_UNSHARDED = {}


def _unsharded(stream: bool):
    """The unsharded run's result and every batch's ids, built with the
    CPU threads a rank of two takes (a build's float sums follow the
    thread count)."""
    from repro_torch.launch.mesh import rank_threads
    from repro_torch.search.serve import SearchEngine
    if stream not in _UNSHARDED:
        served = []
        search = SearchEngine.search

        def record(self, queries, k):
            d, ids = search(self, queries, k)
            served.append(ids.numpy())
            return d, ids

        SearchEngine.search = record
        torch.set_num_threads(rank_threads(2))
        try:
            out = serve.main(SHARDED + (["--stream"] if stream else []),
                             device="cpu")
        finally:
            SearchEngine.search = search
            torch.set_num_threads(1)
        _UNSHARDED[stream] = (out, served)
    return _UNSHARDED[stream]


@pytest.mark.parametrize("extra", [[], ["--donate"], ["--stream"],
                                   ["--snapshot-dir"]],
                         ids=["shards", "donate", "stream", "snapshot"])
def test_sharding_flags_run_through_gloo(extra, tmp_path):
    """``--shards 2 --mesh host`` serves over two gloo ranks on the CPU
    (with ``--donate``, ``--stream``, and ``--snapshot-dir``, which
    restores onto the mesh with ``load_engine(dir, mesh=...)``): every
    batch's ids and the recall equal the unsharded run's."""
    if extra == ["--snapshot-dir"]:
        extra = extra + [str(tmp_path / "snap")]
    stream = "--stream" in extra
    want, served = _unsharded(stream)
    out = serve.main(SHARDED + ["--shards", "2", "--mesh", "host"] + extra,
                     device="cpu")
    sh = out["sharded"]
    assert sh["shards"] == 2 and sh["backend"] == "gloo"
    assert sh["donated"] == (extra == ["--donate"]
                             or extra[:1] == ["--snapshot-dir"])
    assert len(sh["ids"]) == len(served) == 2
    for got, ids in zip(sh["ids"], served):
        assert (got == ids).all()
    assert out["recall"] == want["recall"]
    if stream:
        assert out["stream"] == {**want["stream"],
                                 "rows_per_s": out["stream"]["rows_per_s"]}


@pytest.mark.parametrize("argv,match", [
    (["--shards", "2", "--mesh", "device"], "--mesh host"),
    (["--shards", "2", "--mesh", "host", "--stream", "--durable", "d"],
     "one write-ahead log"),
], ids=["nccl_on_cpu", "durable"])
def test_sharding_flags_refuse_what_cannot_run(argv, match):
    with pytest.raises(ValueError, match=match):
        serve.main(TINY + argv, device="cpu")
