"""The port's serving launcher (repro_torch.launch.serve) on the CPU at a
tiny size: its read-only flags keep the JAX launcher's names and
defaults, it builds and serves each reducer kind with recall against exact
search, and every flag of a layer not ported yet raises with a pointer to
ROADMAP.md. The launchers draw their queries from different generators,
so this compares behaviour, not numbers."""
import sys

import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes at once: one intra-op thread
# each keeps torch's many small CPU ops from contending for the cores
torch.set_num_threads(1)

from repro_torch.launch import serve  # noqa: E402

TINY = ["--corpus", "600", "--dim", "32", "--batch", "16", "--batches", "2"]
READ_ONLY = ("corpus", "dim", "spec", "target_dim", "reducer", "batch",
             "batches", "k", "index", "nlist", "nprobe", "pq_subspaces",
             "lut_dtype", "pq_backend", "query_bucket")


def test_flags_and_defaults_match_the_jax_launcher(monkeypatch):
    from repro.launch import serve as jserve
    monkeypatch.setattr(sys, "argv", ["serve"])
    jargs = vars(jserve._parse_args())
    targs = vars(serve._parse_args([]))
    for name in READ_ONLY:
        assert targs[name] == jargs[name], name
    # every other flag of the JAX launcher is accepted (and refused when
    # set), except the Pallas interpret switch
    assert set(jargs) - set(targs) == {"interpret"}
    for flag, (kw, _) in serve._UNPORTED.items():
        dest = flag[2:].replace("-", "_")
        assert targs[dest] == jargs[dest] == kw.get("default", False)


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


@pytest.mark.parametrize("flag", sorted(serve._UNPORTED))
def test_unported_flags_raise_with_a_pointer(flag):
    kw, _ = serve._UNPORTED[flag]
    if kw.get("action") == "store_true":
        argv = [flag]
    elif "choices" in kw:
        argv = [flag, next(c for c in kw["choices"] if c != kw["default"])]
    else:
        argv = [flag, "3"]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        serve.main(TINY + argv, device="cpu")


def test_ivf_kind_raises_with_a_pointer():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        serve.main(TINY + ["--index", "ivf"], device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        serve.main(TINY + ["--spec", "qpad4>ivf8x2"], device="cpu")


def test_runs_on_cuda_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(TINY + ["--spec", "pca8>rr16"])
