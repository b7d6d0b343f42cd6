"""The per-layer metrics read from the program's own spans and counters
(``repro_torch.search.tracing``): a tiny traced run of the read-only
ivfpq cell and of the stream cell on the CPU reads each of them as a
number, and the write path counts its host syncs."""
import pytest

READ_ONLY = "cohere768-10m.ivfpq.b1024"
STREAM = "cohere768-10m.ivfpq.stream"
SPAN_METRICS = {
    READ_ONLY: ["probe_device_ms", "rerank_device_ms"],
    STREAM: ["stream.probe_device_ms", "stream.delta_scan_device_ms",
             "stream.tombstone_device_ms", "stream.write_syncs_per_step"],
}


@pytest.mark.parametrize("cell", [READ_ONLY, STREAM])
def test_traced_run_reads_the_program_span_metrics(run_tiny, bench_spec,
                                                   cell):
    r = run_tiny(cell, seconds=1.0, traced=True)
    assert r["correct"], r["checks"]
    listed = {m["name"] for m in bench_spec.cell(cell).per_layer
              if m["source"] in ("program_span", "program_counter")
              and m["name"] != "stream.compactions"}
    assert listed == set(SPAN_METRICS[cell])
    for name in SPAN_METRICS[cell]:
        assert r["metrics"][name]["value"] >= 0, name
    if cell == STREAM:
        assert r["metrics"]["stream.write_syncs_per_step"]["value"] >= 1
