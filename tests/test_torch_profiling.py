"""The port's stage tracing (``abnet3_torch.profiling``)."""

import json
import os

import torch

from abnet3_torch.profiling import profiling_enabled, stage_trace


def test_stage_trace_is_a_named_range(monkeypatch):
    monkeypatch.delenv("ABNET3_PROFILE", raising=False)
    assert not profiling_enabled()
    with torch.profiler.profile() as prof:
        with stage_trace("stage-x"):
            torch.ones(4).sum()
    assert "stage-x" in {e.name for e in prof.events()}


def test_stage_trace_captures_each_stage(monkeypatch, tmp_path):
    """With ABNET3_PROFILE=<dir>, each stage writes its own Chrome trace
    under a dated, counter-numbered directory."""
    monkeypatch.setenv("ABNET3_PROFILE", str(tmp_path))
    assert profiling_enabled()
    for _ in range(2):
        with stage_trace("features-spectral"):
            torch.ones(8).cumsum(0)
    dirs = sorted(os.listdir(tmp_path))
    assert len(dirs) == 2 and all(d.startswith("features-spectral-")
                                  for d in dirs)
    assert dirs[0].rsplit("-", 1)[1] != dirs[1].rsplit("-", 1)[1]
    for d in dirs:
        with open(tmp_path / d / "trace.json") as fh:
            trace = json.load(fh)
        assert any(e.get("name") == "features-spectral"
                   for e in trace["traceEvents"])
