"""Model FLOPs of the window's train and dev steps (core/flops.py: the
towers forward and backward on every frame once, the angular-distance
matrices and the DTW recurrence of the same-word pairs, the embedding
cosines) over the window's time and the float32 peak, in %."""


def read(data: dict):
    if not data.get("flops"):
        return None
    return 100.0 * data["flops"] / data["window_s"] / data["peak_flops"]
