"""Sliding-window MAP estimator (port of mmloam_tpu/estimator)."""
