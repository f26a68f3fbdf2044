"""What the train driver reads from a batch of the loader's stream.

A traffic mix names the kind of its batches under ``batches`` (``kind``
and the kind's own keys); a mix whose batches are of another kind brings
a ``Batches`` class in ``traffic/<traffic>.py``. A kind says, of each
batch the loader yields:

- ``count(b)``: the real pairs it trains on (padding of weight 0 left
  out), called once per batch as the loader yields it;
- ``pairs(b)``: (same, diff), the (key1, key2) of those pairs, for the
  check and the FLOP count;
- ``release(b)``: the batch has been given to the trainer;
- ``kernel_shapes(b, n1, n2)``: {kernel: (T1, T2)}, the padded shape of
  each counted kernel's launch for the same pairs of lengths n1, n2.
"""

from __future__ import annotations

import threading


class BankBatches:
    """Index batches into the loader's device-resident token bank (the
    split bank step): the pairs and their weights are on the batch."""

    def __init__(self, driver, spec: dict):
        self.keys = driver.loader.token_bank.keys

    def count(self, b) -> int:
        return int(b.ws.sum() + b.wd.sum())

    def pairs(self, b):
        keys = self.keys
        same = [(keys[i], keys[j]) for i, j, w in
                zip(b.ids1s.tolist(), b.ids2s.tolist(), b.ws.tolist())
                if w > 0]
        diff = [(keys[i], keys[j]) for i, j, w in
                zip(b.ids1d.tolist(), b.ids2d.tolist(), b.wd.tolist())
                if w > 0]
        return same, diff

    def release(self, b) -> None:
        pass

    def kernel_shapes(self, b, n1, n2) -> dict:
        return {"dtw_path": (b.bucket, b.bucket)}


def _pow2(n: int, minimum: int = 8) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


class FrameBatches:
    """Aligned frame-pair batches that the loader's ``builder`` method
    (``spec["builder"]``: ``load_frames_from_pairs_device`` on the device
    backend, ``load_frames_from_pairs`` on the host's) builds from the
    grouped pairs it is handed: the pairs are taken from that call, on
    the thread that builds the batch."""

    def __init__(self, driver, spec: dict):
        self.grouped, self._last = {}, {}
        self.device_kernels = spec.get("builder") == \
            "load_frames_from_pairs_device"
        loader = driver.loader
        build = getattr(loader, spec["builder"])

        def builder(pairs, *a, **kw):
            self._last[threading.get_ident()] = pairs
            return build(pairs, *a, **kw)
        setattr(loader, spec["builder"], builder)

    def count(self, b) -> int:
        grouped = self._last.pop(threading.get_ident())
        self.grouped[id(b)] = grouped
        return len(grouped["same"]) + len(grouped["diff"])

    def pairs(self, b):
        grouped = self.grouped[id(b)]
        return ([(p[:3], p[3:6]) for p in grouped["same"]],
                [(p[:3], p[3:6]) for p in grouped["diff"]])

    def release(self, b) -> None:
        self.grouped.pop(id(b), None)

    def kernel_shapes(self, b, n1, n2) -> dict:
        if not self.device_kernels:
            return {}
        return {"dtw_moves": (_pow2(max(n1)), _pow2(max(n2)))}


KINDS = {"bank": BankBatches, "frames": FrameBatches}


def batches_for(driver):
    """The kind of batches the cell's traffic names, or the traffic's own
    ``Batches``."""
    cell = driver.cell
    spec = cell.traffic["batches"]
    code = cell.traffic_code
    cls = getattr(code, "Batches", None) if code is not None else None
    return (cls or KINDS[spec["kind"]])(driver, spec)
