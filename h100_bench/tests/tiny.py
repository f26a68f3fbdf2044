"""Cells of BENCHMARK.json cut to a size the CPU runs in seconds, for the
benchmark's own tests (the program's plain versions stand in for the
kernels there)."""

from __future__ import annotations

from contextlib import contextmanager

import torch

from h100_bench.core.cell import Cell


def tiny_cell(name: str) -> Cell:
    cell = Cell(name)
    t = cell.traffic
    t["corpus"].update(n_tokens=600, n_classes=60, n_speakers=4,
                       tokens_per_file=50)
    if "pairs" in t:
        t["pairs"]["n_pairs"] = 3000
        t["loader"]["num_max_minibatches"] = 4
        bank = t["loader"]["align_backend"] == "bank"
        t["first_steps"]["batches"] = 16 if bank else 3
        if bank:
            # a bucket's buffer fills within each epoch, so its first
            # steps come back through give_batch_to_network
            t["loader"]["num_max_minibatches"] = 16
        t["loader"]["batch_size"] = 16
        if bank:
            t["loader"]["steps_per_call"] = 4
    if "eval" in t:
        t["eval"].update(n_items=48, block=16, check_frames=512,
                         check_pairs=64, batch_size=1000)
        cell.config.values["abx_n_tokens"] = 48
    t["trace_slice"] = {"skip": 1, "warmup": 1, "active": 1}
    return cell


@contextmanager
def tiles_on_cpu():
    """The tile strategy (as on the card at 4,096 items) for the tiny
    item sets too, which the program would score by the pair stream."""
    from abnet3_torch.eval import abx
    prev = abx._TILE_MIN_TOKENS
    abx._TILE_MIN_TOKENS = 0
    try:
        yield
    finally:
        abx._TILE_MIN_TOKENS = prev


def run_tiny(cell: Cell, seed: int = 2 ** 31 + 5, seconds: float = 0.0):
    from h100_bench import run as harness
    with tiles_on_cpu():
        return harness.run(cell, seed, seconds, False, torch.device("cpu"),
                           t_start=0.0)
