"""The run refuses to start without a card; nothing the harness or the
references import is JAX or the JAX package, and the references import
nothing of the program."""

import glob
import os
import re
import subprocess
import sys

import pytest

from h100_bench.core.cell import HERE, ROOT, all_cells

IMPORT = re.compile(r"^\s*(import|from)\s+(abnet3_torch|abnet3_tpu|jax)\b",
                    re.M)
FORBIDDEN = {"jax", "jaxlib", "optax", "flax", "abnet3_tpu"}


def test_run_fails_without_a_card(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from h100_bench import run
    rc = run.main(["--workload", all_cells()[0], "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def _loaded_in_fresh_interpreter(code: str):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True,
        env=dict(os.environ, PYTHONPATH=ROOT))
    return set(out.stdout.split())


def test_harness_and_program_load_no_jax():
    code = "\n".join([
        "import h100_bench.run",
        "from h100_bench.core import abx, train, cell, check, trace",
        "from h100_bench.core.cell import Cell, all_cells, metric_reader",
        "for n in all_cells():",
        "    c = Cell(n); c.config.model; c.config.reference",
        "    [metric_reader(m['name']) for m in c.per_layer]",
        "import abnet3_torch.trainer, abnet3_torch.dataloader",
        "import abnet3_torch.embedder, abnet3_torch.eval.abx",
        "import abnet3_torch.eval.abx_device, abnet3_torch.ops.bank",
        "import abnet3_torch.weights, abnet3_torch.loss"])
    loaded = _loaded_in_fresh_interpreter(code)
    assert "abnet3_torch" in loaded
    assert not loaded & FORBIDDEN


def test_references_load_nothing_of_the_program():
    refs = sorted(glob.glob(os.path.join(HERE, "configs", "*",
                                         "reference.py")))
    assert refs
    code = "\n".join(
        ["import importlib.util",
         "from h100_bench.reference import abx, dtw, train_step"]
        + [f"s = importlib.util.spec_from_file_location('r{i}', {p!r})\n"
           "importlib.util.module_from_spec(s)\n"
           f"s.loader.exec_module(importlib.util.module_from_spec(s))"
           for i, p in enumerate(refs)])
    loaded = _loaded_in_fresh_interpreter(code)
    assert not loaded & (FORBIDDEN | {"abnet3_torch"})
    for path in refs + glob.glob(os.path.join(HERE, "reference", "*.py")):
        with open(path) as fh:
            assert not IMPORT.search(fh.read()), path

