"""Milliseconds of the harness's span around the embedder's export of the
whole corpus (5,000-row chunks through the tower, the transfer codec and
the drain) per pass of the window: what ``abnet3-embed`` users wait on,
per 1.74 M frames."""


def read(data: dict):
    s, n = data.get("export_s"), data.get("passes")
    return 1e3 * s / n if s and n else None
