"""The program's own spans and counters (``abnet3_torch.profiling``).

A traced run turns them on at the start of its window and reads their
totals over the same stretch as the other per-layer readers. A program
without them (an older commit) reads None and raises nothing.

``ReadsSpans`` puts that on a core driver without an edit to it: a mix
gets it from the ``Driver`` of its ``traffic/<traffic>.py``,

    class Driver(ReadsSpans, TrainDriver):
        rounds = "epochs"

and its ``layer_data()`` then carries the totals under ``"spans"``. A
reader takes a span's total over a count with ``mean(data, name,
per=...)``; ``h100_bench/idle_spans.py`` splits a traced slice's idle
time by the program span open on the main thread.
"""

from __future__ import annotations

from typing import Optional


def _profiling():
    try:
        from abnet3_torch import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "span_totals"):
        return None
    return profiling


def start() -> None:
    """Turn the program's spans on, where it has them."""
    p = _profiling()
    if p is not None:
        p.spans_on()


def totals() -> Optional[dict]:
    """``{"spans": {name: {count, total_s, self_s}}, "counters": {name:
    value}}`` so far, or None."""
    p = _profiling()
    return p.span_totals() if p is not None else None


def since(before: Optional[dict], after: Optional[dict]) -> Optional[dict]:
    """The totals ``after`` less those ``before``, names that did not
    move left out; None where either is."""
    if before is None or after is None:
        return None
    return _profiling().totals_since(before, after)


def mean(data: dict, name: str, per: Optional[str] = None,
         of: str = "total_s") -> Optional[float]:
    """The span ``name``'s ``of`` (seconds) over the count of the span
    ``per`` (default itself), or None where either is missing."""
    s = (data.get("spans") or {}).get("spans", {})
    if name not in s or (per or name) not in s:
        return None
    n = s[per or name]["count"]
    return s[name][of] / n if n else None


class ReadsSpans:
    """Mixed in before a core driver: with ``--trace 1`` the program's
    spans are on for the whole window, and ``layer_data()`` gains
    ``"spans"``, their totals over the rounds that the other readers
    read (after the core's ``mark`` where the window ran more than one
    round, else the whole window). ``rounds`` names the core's count of
    rounds (``epochs`` or ``passes``). Untraced runs are the core's."""

    rounds = "epochs"
    _mark = None

    def window(self, seconds: float) -> None:
        self._span_marks = []
        if self.trace:
            start()
            self._span_marks.append(totals())
        super().window(seconds)
        self._span_end = totals() if self.trace else None

    @property
    def mark(self):
        return self._mark

    @mark.setter
    def mark(self, value) -> None:
        # the core sets its mark after the traced round: the spans that
        # the readers take start there too
        self._mark = value
        if value is not None and self.trace:
            self._span_marks.append(totals())

    def layer_data(self) -> dict:
        data = super().layer_data()
        marks = self._span_marks
        if marks:
            first = marks[-1] if getattr(self, self.rounds) > 1 else marks[0]
            data["spans"] = since(first, self._span_end)
        return data
