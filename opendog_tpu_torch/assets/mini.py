"""Minimal 2-leg test robot ("mini"): free trunk + 2 single-hinge legs with
paw spheres.

Purpose-built so the fused-kernel stack (ops/scalar_core, ops/pallas_step)
can be exercised in the default test gate: its scalarized graph compiles in
seconds on the CPU backend, vs minutes for go1/opendog (whose kernel tests
run under OPENDOG_SLOW_TESTS=1).  Shares the block-arrow structure the
kernels require (floating base + G equal-length chains; here G=2, n=1) and
the same contact/actuator model as the real robots."""
from __future__ import annotations

MINI_XML = """
<mujoco model="mini">
  <option timestep="0.002"/>
  <worldbody>
    <body name="trunk" pos="0 0 0.12">
      <freejoint/>
      <geom type="sphere" size="0.04" mass="1.0"/>
      <body name="legF" pos="0.08 0 0">
        <joint name="hipF" type="hinge" axis="0 1 0" range="-1.2 1.2"/>
        <geom type="capsule" fromto="0 0 0 0 0 -0.09" size="0.012"
              mass="0.08"/>
        <body name="pawF" pos="0 0 -0.1">
          <geom type="sphere" size="0.015" mass="0.02"/>
        </body>
      </body>
      <body name="legB" pos="-0.08 0 0">
        <joint name="hipB" type="hinge" axis="0 1 0" range="-1.2 1.2"/>
        <geom type="capsule" fromto="0 0 0 0 0 -0.09" size="0.012"
              mass="0.08"/>
        <body name="pawB" pos="0 0 -0.1">
          <geom type="sphere" size="0.015" mass="0.02"/>
        </body>
      </body>
    </body>
  </worldbody>
  <actuator>
    <position name="hipF_act" joint="hipF" kp="25" kv="1"
              ctrlrange="-1.2 1.2"/>
    <position name="hipB_act" joint="hipB" kp="25" kv="1"
              ctrlrange="-1.2 1.2"/>
  </actuator>
  <keyframe>
    <key name="home" qpos="0 0 0.115 1 0 0 0 0 0" ctrl="0 0"/>
  </keyframe>
</mujoco>
"""


def mini_xml() -> str:
    return MINI_XML
