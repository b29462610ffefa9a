"""The readers of the program's spans and counters on the small cells, on
the CPU: the host readers give a number, the device readers nothing; and
against a program without a tracer every one of them gives nothing."""

import tempfile
import time
import types

import pytest
import torch

from portbench import harness

DEVICE_READERS = ("fwd_device_ms", "loss_device_ms", "bwd_device_ms")
SOURCES = ("program_span", "program_counter")


def program_metrics(cell=None):
    return [m for m in harness.load_manifest()["per_layer"]
            if m["source"] in SOURCES and (cell is None or cell in m["workloads"])]


@pytest.mark.parametrize("cell", [w["name"] for w in harness.load_manifest()["workloads"]])
def test_span_readers_on_the_small_cells(cell, small_cell, tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        cfg, traffic = small_cell(cell)
        result = harness.run_cell(cell, 2 ** 31 + 7, 0.2, True, torch.device("cpu"),
                                  time.perf_counter(), cfg=cfg, traffic=traffic)
    finally:
        torch.set_num_threads(threads)
    metrics = result["metrics"]
    for m in program_metrics(cell):
        if m["name"] in DEVICE_READERS:
            assert m["name"] not in metrics
        else:
            value = metrics[m["name"]]["value"]
            assert isinstance(value, float) and value >= 0, (m["name"], value)
    if "spmm_launches" in metrics:  # the plain product on the CPU launches no kernel
        assert metrics["spmm_launches"]["value"] == 0
    if "graph_build_s" in metrics:
        assert metrics["graph_build_s"]["value"] > 0
    assert result["correct"]


def test_a_program_without_a_tracer_reads_nothing(monkeypatch):
    from chromegcn_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "device_timing")
    calls = []
    session = types.SimpleNamespace(device=torch.device("cuda"), step=calls.append)
    for m in program_metrics():
        assert harness.reader(m["name"])(session) is None, m["name"]
    assert calls == []
