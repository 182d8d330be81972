"""Host-side data layer: synthetic worlds (a numpy-only copy of
mmloam_tpu/data/synthetic.py), the rosbag reader and writer, bag-to-tensor
decode, rig calibration and export."""
