"""Share of the traced slice's wall time with no kernel or copy on the
card, in %."""


def read(data: dict):
    tr = data.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
