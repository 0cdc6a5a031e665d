"""Carry the JAX reference's planned state into the port.

This system has no weights: its parameters are the coefficients each op
plans from its params.  `ansel_tpu.Pipeline.coeffs()` returns them per
stage as numpy arrays, Python floats and lists, the same host form the
port's own `Pipeline.coeffs()` produces, so one conversion serves both.
With it a test feeds both packages the same numbers.  Nothing here
imports the reference.
"""

from __future__ import annotations

from .pipeline.engine import coeffs_to_device


def coeffs_from_reference(coeffs, device):
    """ansel_tpu `Pipeline.coeffs()` -> the port's per-stage dicts of
    float32 tensors on `device`."""
    return coeffs_to_device(coeffs, device)
