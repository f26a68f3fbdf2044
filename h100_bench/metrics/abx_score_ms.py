"""Milliseconds of the harness's span around ``abx_error_device`` (both
tasks) per pass of the window."""


def read(data: dict):
    s, n = data.get("score_s"), data.get("passes")
    return 1e3 * s / n if s and n else None
