"""Hand-written CUDA kernels (sources in ../csrc) with their plain torch
twins: rcd.py, pointwise.py, sepblur.py, eaw.py and nlm.py."""
