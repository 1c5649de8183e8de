"""Sim-to-real: the sim / real joint-angle calibration and the walk.json
gait artifact."""
