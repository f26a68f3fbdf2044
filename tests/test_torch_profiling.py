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


def test_stage_trace_names_the_rank(monkeypatch, tmp_path):
    """A rank of a process group of several puts ``rank<r>`` in its
    capture directory's name, so ranks do not overwrite each other's
    traces; a lone process does not."""
    import types

    from abnet3_torch import profiling
    monkeypatch.setenv("ABNET3_PROFILE", str(tmp_path))
    for world in (2, 1):
        monkeypatch.setattr(profiling, "dist", types.SimpleNamespace(
            is_available=lambda: True, is_initialized=lambda: True,
            get_world_size=lambda: world, get_rank=lambda: 1))
        with stage_trace("train-epoch-0"):
            torch.ones(4).sum()
    dirs = sorted(os.listdir(tmp_path))
    assert len(dirs) == 2
    assert sum(d.startswith("train-epoch-0-rank1-") for d in dirs) == 1
    assert sum("-rank" not in d for d in dirs) == 1
