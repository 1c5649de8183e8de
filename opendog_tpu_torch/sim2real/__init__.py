"""Sim-to-real: the sim / real joint-angle calibration, the walk.json gait
artifact, the digital twin that mirrors the robot's measured joints, the
scripted trot designer and its replay, and the actuator perturbation
table."""
