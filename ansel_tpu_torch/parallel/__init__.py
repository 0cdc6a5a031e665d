"""Multi-device execution (`ansel_tpu/parallel`): batch sharding over the
mesh's "dp" axis, row sharding of one image over "sp" (`batch.py`,
`spatial.py`), on the single-controller mesh of `mesh.py`."""
