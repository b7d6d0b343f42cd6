"""The benchmark of the PyTorch / CUDA port's vector search engine.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` on one CUDA card from the root of a
checkout, and prints, as the last line of its standard output, one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number the comparison read beside its limit, which are also the last
lines of its standard error. ``--control 1`` puts the reference at TF32
in the program's place (the control the comparison must refuse) and
times nothing.

It exits with a non-zero code and prints no result when no CUDA card is
present, when the checkout lacks the port, or when the process has loaded
JAX or the JAX package once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _environment():
    """Caches inside the checkout at fixed paths, and the port and the
    harness importable."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)
    os.environ["USE_FLAX"] = "0"
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("the checkout holds no src/repro_torch: nothing to measure",
              file=sys.stderr)
        return 2
    from bench import harness
    from bench.catalog import Benchmark
    bench = Benchmark.load(ROOT)
    cell = bench.cell(args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    readers = bench.metric_readers(cell) if args.trace else None
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda"), T_START,
                         control=bool(args.control), readers=readers)
    bad = harness.forbidden_modules()
    if bad:
        print(f"the process loaded {bad}: the port must not import JAX or "
              "the JAX package", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} {c['rule']} {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
