"""Plain PyTorch and NumPy references of what the timed path computes.

Nothing here imports the program (``abnet3_torch``) or JAX: these are
written from the published descriptions of ABnet3 (DTW-aligned word
pairs, the coscos2 loss, adadelta, the ABX error) and take nothing the
program made.
"""
