"""Observation ops and hand-written frame kernels."""
