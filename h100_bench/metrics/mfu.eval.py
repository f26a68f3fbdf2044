"""Model FLOPs of the window's eval passes (the export's tower on every
frame, the tiles' cosine products and DTW recurrence over the needed
cells) over the passes' time and the float32 peak, in %."""


def read(data: dict):
    if not data.get("flops"):
        return None
    return 100.0 * data["flops"] / data["window_s"] / data["peak_flops"]
