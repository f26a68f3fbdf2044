"""Milliseconds of the harness's span around ``distance_matrix`` per tile,
over the window's passes: the tiles of a pass are those of side
``block`` that cover the upper triangle of the N x N item matrix, t(t +
1)/2 with t = ceil(N / block) (10 at N = 4,096 and a side of 1,024),
whatever tiling the program runs."""


def read(data: dict):
    s, tiles = data.get("distance_s"), data.get("tiles")
    return 1e3 * s / tiles if s and tiles else None
