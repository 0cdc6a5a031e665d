"""Host-side numerical utilities copied from `ansel_tpu/utils` (numpy
and pure Python; no JAX)."""
