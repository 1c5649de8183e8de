"""Programmatic description of the OpenDOG 8-DoF quadruped.

This is a from-scratch re-encoding of the robot that
``Code/mujoco/our_robot/our_robot.xml`` describes — the same
kinematic tree, joint ranges, actuator gains and mass distribution — expressed
as Python data tables and an MJCF *generator* (the framework ships no copied
XML or STL assets).

Mesh-derived quantities (inertials, collision support spheres) were computed
once from the reference STL geometry and are embedded below as constants:
  * body inertials equal the values the MuJoCo compiler derives from the
    meshes (uniform-density mesh integration), so the smooth dynamics match
    the reference model exactly;
  * each 2 mm-thick paw plate (bbox half-extents 0.0021 x 0.0096 x 0.0120 in
    its geom frame) is represented by four corner spheres of radius 2.083 mm
    lying in the paw body's z=0 plane — reproducing both the plate's support
    height and its face-contact footprint (MuJoCo generates 3 contacts per paw
    face on flat ground; see our_robot.xml:54-56 paw placement);
  * thigh/calf meshes become single support spheres (contact only matters
    when the robot falls).

Reference provenance: tree/pos/quats our_robot.xml:41-95, joint classes
:13-21, actuator order :99-111, keyframe :113-117, friction :9,24,
armature/frictionloss :10, kp/kv/forcerange :11.
"""
from __future__ import annotations

# Leg frame offsets in the trunk frame (our_robot.xml:48,60,72,84) and the
# within-leg offsets (calf in thigh frame, paw in calf frame).
LEGS = {
    # name: (tigh_pos, calf_pos, paw_pos, side)
    "FL": ((0.0705, 0.0816, -0.0013), (0.0376, 0.0096, -0.0008), (0.0416, 0.004, -0.0096), "L"),
    "FR": ((0.0705, -0.079, -0.0013), (0.0376, -0.0099, -0.0008), (0.0416, -0.0076, -0.0096), "R"),
    "BL": ((-0.0945, 0.0816, 0.0005), (0.0376, 0.0096, -0.0008), (0.0416, -0.0076, -0.0096), "L"),
    "BR": ((-0.0945, -0.079, 0.0005), (0.0376, -0.0099, -0.0008), (0.0416, -0.0076, -0.0096), "R"),
}
PAW_QUAT = (0.0, -0.38268343, 0.0, 0.92387953)  # our_robot.xml:54

# Mesh-derived inertials (MuJoCo-compiler uniform-density mesh integration of
# the reference STLs; trunk chasis mass 1.858, thigh .01377, calf .01036,
# paw .001 — our_robot.xml:45,49,52,24).
TRUNK_INERTIAL = dict(
    mass=1.858,
    pos=(0.00023852, -0.00016037, -0.00089102),
    quat=(2.24476778e-04, 7.10332941e-01, -3.78488376e-04, 7.03865697e-01),
    diaginertia=(0.01180467, 0.00767014, 0.0046922),
)
TIGH_INERTIAL = {
    "L": dict(mass=0.01377,
              pos=(-1.85339566e-03, -2.95909738e-03, -2.26439689e-08),
              quat=(0.45888841, 0.45888841, 0.53797902, 0.53797902),
              diaginertia=(2.00566399e-06, 1.94775417e-06, 9.61095226e-07)),
    "R": dict(mass=0.01377,
              pos=(-1.85339544e-03, -1.98415995e-04, -2.26439689e-08),
              quat=(0.53797902, 0.53797902, 0.45888841, 0.45888841),
              diaginertia=(2.00566405e-06, 1.94775423e-06, 9.61095221e-07)),
}
CALF_INERTIAL = {
    "L": dict(mass=0.01036,
              pos=(0.01270162, 0.00411945, -0.00260896),
              quat=(0.44341521, 0.54668859, 0.53264919, 0.46989294),
              diaginertia=(3.99723888e-06, 3.92307943e-06, 2.31575292e-07)),
    "R": dict(mass=0.01036,
              pos=(0.01270162, -0.00727696, -0.00260896),
              quat=(0.46989292, 0.53264921, 0.54668857, 0.44341523),
              diaginertia=(3.99723888e-06, 3.92307943e-06, 2.31575295e-07)),
}
PAW_INERTIAL = dict(
    mass=0.001,
    pos=(-3.83853584e-04, -2.06215237e-06, 2.67922048e-06),
    quat=(0.0, 0.70710678, 0.0, 0.70710678),
    diaginertia=(7.00404077e-08, 4.25425255e-08, 2.98641980e-08),
)

# Collision support spheres (body frame): paw = 4 plate-corner spheres,
# thigh/calf = single support sphere matching the mesh's lowest point at the
# home keyframe.
PAW_SPHERES = [
    (0.009012, -0.00749, 0.000003),
    (-0.00978, -0.00749, 0.000003),
    (0.009012, 0.007486, 0.000003),
    (-0.00978, 0.007486, 0.000003),
]
PAW_SPHERE_R = 0.002083
TIGH_SPHERE = {"L": (-0.001853, -0.002959, 0.0), "R": (-0.001853, -0.000198, 0.0)}
TIGH_SPHERE_R = 0.030086
CALF_SPHERE = {"L": (0.012702, 0.004119, -0.002609), "R": (0.012702, -0.007277, -0.002609)}
CALF_SPHERE_R = 0.023369

# Joint / actuator parameters (our_robot.xml:10-21).
TIGH_RANGE = (2.36, 2.8)
KNEE_RANGE = (-1.8, -1.2)
ARMATURE = 0.02
FRICTIONLOSS = 0.1
KP, KV = 25.0, 1.0
FORCERANGE = (-0.83, 0.83)
PAW_FRICTION = (0.516, 0.141, 0.01)  # our_robot.xml:24
LEG_FRICTION = (0.6, 0.005, 0.0001)  # our_robot.xml:9

# Actuator declaration order (our_robot.xml:99-111) — note it interleaves
# legs differently from the joint/qpos order (FL,FR,BL,BR).
ACTUATOR_ORDER = ["FR", "BR", "FL", "BL"]
ACTUATOR_NAMES = [
    f"{leg}_{part}_actuator" for leg in ACTUATOR_ORDER for part in ("tigh", "knee")
]

# Home keyframe (our_robot.xml:113-117).
HOME_HEIGHT = 0.20
HOME_TIGH = 2.35619
HOME_KNEE = -1.5708

# Terrain heightfield spec (walking_scene.xml:19) and the hidden obstacle of
# walking_scene_terrain.xml:25-31.
HFIELD = dict(nrow=100, ncol=100, size=(5.0, 5.0, 0.3, 0.001))
TERRAIN_OBSTACLE = dict(pos=(1.5, 0.0, 0.05), size=(0.15, 0.25, 0.05))


def _fmt(v) -> str:
    return " ".join(f"{x:.9g}" for x in v)


def _leg_xml(name: str) -> str:
    tigh_pos, calf_pos, paw_pos, side = LEGS[name]
    ti, ci = TIGH_INERTIAL[side], CALF_INERTIAL[side]
    paw_spheres = "\n".join(
        f'        <geom type="sphere" pos="{_fmt(p)}" size="{PAW_SPHERE_R}" '
        f'friction="{_fmt(PAW_FRICTION)}"/>'
        for p in PAW_SPHERES
    )
    return f"""
    <body name="{name}_tigh" pos="{_fmt(tigh_pos)}">
      <inertial mass="{ti['mass']}" pos="{_fmt(ti['pos'])}" quat="{_fmt(ti['quat'])}" diaginertia="{_fmt(ti['diaginertia'])}"/>
      <joint name="{name}_tigh_joint" type="hinge" axis="0 1 0" pos="-0.005 0 0" range="{_fmt(TIGH_RANGE)}" armature="{ARMATURE}" frictionloss="{FRICTIONLOSS}"/>
      <geom type="sphere" pos="{_fmt(TIGH_SPHERE[side])}" size="{TIGH_SPHERE_R}" friction="{_fmt(LEG_FRICTION)}"/>
      <body name="{name}_calf" pos="{_fmt(calf_pos)}">
        <inertial mass="{ci['mass']}" pos="{_fmt(ci['pos'])}" quat="{_fmt(ci['quat'])}" diaginertia="{_fmt(ci['diaginertia'])}"/>
        <joint name="{name}_knee_joint" type="hinge" axis="0 1 0" pos="-0.0024 0 0.0008" range="{_fmt(KNEE_RANGE)}" armature="{ARMATURE}" frictionloss="{FRICTIONLOSS}"/>
        <geom type="sphere" pos="{_fmt(CALF_SPHERE[side])}" size="{CALF_SPHERE_R}" friction="{_fmt(LEG_FRICTION)}"/>
        <body name="{name}_paw" pos="{_fmt(paw_pos)}" quat="{_fmt(PAW_QUAT)}">
          <inertial mass="{PAW_INERTIAL['mass']}" pos="{_fmt(PAW_INERTIAL['pos'])}" quat="{_fmt(PAW_INERTIAL['quat'])}" diaginertia="{_fmt(PAW_INERTIAL['diaginertia'])}"/>
{paw_spheres}
        </body>
      </body>
    </body>"""


def opendog_xml(scene: str = "flat") -> str:
    """Generate the OpenDOG MJCF.  ``scene``: 'flat' | 'terrain' | 'none'."""
    if scene not in ("flat", "terrain", "none"):
        raise ValueError(f"unknown scene {scene!r}: use 'flat'|'terrain'|'none'")
    legs = "".join(_leg_xml(n) for n in ("FL", "FR", "BL", "BR"))
    actuators = "\n".join(
        f'    <position name="{leg}_{part}_actuator" joint="{leg}_{part}_joint" '
        f'kp="{KP}" kv="{KV}" forcerange="{_fmt(FORCERANGE)}" '
        f'ctrlrange="{_fmt(TIGH_RANGE if part == "tigh" else KNEE_RANGE)}"/>'
        for leg in ACTUATOR_ORDER
        for part in ("tigh", "knee")
    )
    home_qpos = f"0 0 {HOME_HEIGHT} 1 0 0 0" + f" {HOME_TIGH} {HOME_KNEE}" * 4
    home_ctrl = f"{HOME_TIGH} {HOME_KNEE} " * 4
    world = ""
    assets = ""
    if scene == "flat":
        world = '    <geom name="floor" type="plane" size="0 0 0.05"/>'
    elif scene == "terrain":
        assets = (f'  <asset><hfield name="terrain_hfield" nrow="{HFIELD["nrow"]}" '
                  f'ncol="{HFIELD["ncol"]}" size="{_fmt(HFIELD["size"])}"/></asset>')
        world = (
            f'    <geom name="terrain_hfield" type="hfield" hfield="terrain_hfield"/>\n'
            f'    <body name="obstacle" pos="{_fmt(TERRAIN_OBSTACLE["pos"])}">'
            f'<geom name="obstacle" type="box" size="{_fmt(TERRAIN_OBSTACLE["size"])}"/></body>'
        )
    return f"""<mujoco model="opendog_tpu">
  <compiler angle="radian" autolimits="true"/>
  <option gravity="0 0 -9.81" timestep="0.002"/>
{assets}
  <worldbody>
{world}
    <body name="trunk" pos="0 0 0.15">
      <inertial mass="{TRUNK_INERTIAL['mass']}" pos="{_fmt(TRUNK_INERTIAL['pos'])}" quat="{_fmt(TRUNK_INERTIAL['quat'])}" diaginertia="{_fmt(TRUNK_INERTIAL['diaginertia'])}"/>
      <joint type="free" armature="{ARMATURE}" frictionloss="{FRICTIONLOSS}"/>
{legs}
    </body>
  </worldbody>
  <actuator>
{actuators}
  </actuator>
  <keyframe>
    <key name="home" qpos="{home_qpos}" ctrl="{home_ctrl.strip()}"/>
  </keyframe>
</mujoco>
"""
