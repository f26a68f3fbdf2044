"""Device compute ops: angular distances, DTW path masks, the token bank."""
