"""Mean milliseconds of one ``next()`` on the loader's batch stream in the
train passes of the window (the harness's own span; with prefetch the
loader builds on a worker thread, so this is the build's time, not the
step's wait for it)."""


def read(data: dict):
    spans = data.get("batch_build_s.train") or []
    return 1e3 * sum(spans) / len(spans) if spans else None
