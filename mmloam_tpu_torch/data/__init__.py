"""Host-side data layer: synthetic worlds (a numpy-only copy of
mmloam_tpu/data/synthetic.py)."""
