"""Device milliseconds of the pipe step that runs local contrast (bilat's
local Laplacian in torch, `ops/bilat.py` -> `pixel/locallaplacian.py`),
per image, between CUDA events around that step alone."""


def read(r):
    t = r.step_seconds("bilat")
    return None if t is None else 1e3 * t
