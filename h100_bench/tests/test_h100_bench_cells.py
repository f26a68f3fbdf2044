"""The harness finds every cell's configuration, traffic, limits, metric
readers and kernel counts by name, and BENCHMARK.json keeps to the
shape the harness reads."""

import json
import os
import re

import pytest

from h100_bench.core import cell as cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def bench():
    with open(os.path.join(cells.ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


@pytest.mark.parametrize("name", cells.all_cells())
def test_cell_files_are_found_by_name(name):
    c = cells.Cell(name)
    for f in ("config.json", "model.py", "reference.py"):
        assert os.path.exists(os.path.join(c.config.dir, f))
    for fn in ("init_weights", "forward", "shapes", "head_dims"):
        assert callable(getattr(c.config.reference, fn))
    assert c.traffic["driver"] in ("train", "eval") or \
        hasattr(c.traffic_code, "Driver")
    assert c.limits
    for m in c.per_layer:
        assert callable(cells.metric_reader(m["name"]).read)
    for k in c.traffic.get("kernels", []):
        assert callable(cells.kernel_counts(k).bound_s)
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2 and c.per_layer


def test_benchmark_json_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = ([c["name"] for c in b["configs"]]
             + [w["name"] for w in b["workloads"]]
             + [m["name"] for m in b["end_to_end"] + b["per_layer"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    cells_ = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells_)) for m in
           b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= e2e[m["moves"]]
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for c in b["configs"]:
        with open(os.path.join(cells.ROOT, c["file"])) as fh:
            values = json.load(fh)
        assert values["source"] == c["source"]
        assert values["reduced"] == c["reduced"]
    for w in b["workloads"]:
        assert w["chips"] == 1


def test_metric_readers_return_nothing_without_data():
    empty = {"trace": None, "kernel_bounds": {}, "flops": 0.0,
             "window_s": 1.0, "peak_flops": 1.0}
    for m in bench()["per_layer"]:
        assert cells.metric_reader(m["name"]).read(empty) is None


def test_traffic_code_supplies_the_driver_and_the_batches(tmp_path):
    """A mix that needs code brings ``traffic/<traffic>.py``: its
    ``Driver`` replaces the core driver, its ``Batches`` the core kind."""
    import types

    from h100_bench import run as harness
    from h100_bench.core.batches import batches_for

    class Driver:
        def __init__(self, cell, seed, device, trace, workdir):
            self.args = (cell, seed, device, trace, workdir)

    class Batches:
        def __init__(self, driver, spec):
            self.spec = spec

    c = cells.Cell(cells.all_cells()[0])
    c.traffic_code = types.SimpleNamespace(Driver=Driver, Batches=Batches)
    d = harness.driver_for(c, 5, "cpu", False, str(tmp_path))
    assert isinstance(d, Driver) and d.args[1] == 5
    d.cell = c
    assert batches_for(d).spec == c.traffic["batches"]
