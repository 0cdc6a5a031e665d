"""Whole-image pixel algorithms (`ansel_tpu/pixel`): fast bit-trick
exponentials, shifted-view stencils, resampling, edge-aware wavelets and
non-local means."""
