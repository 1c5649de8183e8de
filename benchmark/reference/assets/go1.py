# Frozen copy of opendog_tpu_torch/assets/go1.py at commit 9b29168 (the benchmark's reference:
# later changes to the program do not reach it).  Imports rewritten only.
"""Programmatic description of the Unitree Go1 12-DoF quadruped.

Re-encoding of the reference's ``Code/mujoco/unitree_go1/go1.xml`` as Python
data tables + an MJCF generator.  All inertials are the explicit values of the
reference (go1.xml ``<inertial>`` elements); collision geometry uses the
reference's own primitive collision classes (go1.xml:26-65) written out
explicitly.  Scenes reproduce the intent of jump_scene.xml / landing_scene.xml
/ walk_scene.xml (the committed jump_scene.xml does not load in MuJoCo — it
duplicates the body name ``trunk`` — so the jump scene here places the floor
at z=0 and the platform cube per jump_scene.xml:26-28).
"""
from __future__ import annotations

# (name, parent_leg_frame_positions): hip in trunk, thigh in hip, calf in thigh
LEG_POS = {
    "FR": ((0.1881, -0.04675, 0.0), (0.0, -0.08, 0.0)),
    "FL": ((0.1881, 0.04675, 0.0), (0.0, 0.08, 0.0)),
    "RR": ((-0.1881, -0.04675, 0.0), (0.0, -0.08, 0.0)),
    "RL": ((-0.1881, 0.04675, 0.0), (0.0, 0.08, 0.0)),
}
CALF_POS = (0.0, 0.0, -0.213)
FOOT_POS = (0.0, 0.0, -0.213)  # foot sphere + site in calf frame (go1.xml:62,119)
FOOT_RADIUS = 0.023
FOOT_FRICTION = (0.8, 0.02, 0.01)
# The reference foot pads are deliberately compliant: solimp="0.015 1 0.023"
# (go1.xml:62) yields ~13 mm static penetration under the robot's weight in
# MuJoCo.  Matching spring: 31 N/foot / 0.0132 m ≈ 2.37 kN/m, ~critical
# damping for the ~3.2 kg per-foot share.
FOOT_SOLREF = (-2370.0, -174.0)
BODY_FRICTION = (0.6, 0.005, 0.0001)

TRUNK_INERTIAL = dict(
    mass=5.204, pos=(0.0223, 0.002, -0.0005),
    quat=(-0.00342088, 0.705204, 0.000106698, 0.708996),
    diaginertia=(0.0716565, 0.0630105, 0.0168101),
)
HIP_INERTIAL = {
    "FR": dict(mass=0.68, pos=(-0.0049166, 0.00762615, -8.865e-05),
               quat=(0.507341, 0.514169, 0.495027, 0.482891),
               diaginertia=(0.000734064, 0.000468438, 0.000398719)),
    "FL": dict(mass=0.68, pos=(-0.0049166, -0.00762615, -8.865e-05),
               quat=(0.482891, 0.495027, 0.514169, 0.507341),
               diaginertia=(0.000734064, 0.000468438, 0.000398719)),
    "RR": dict(mass=0.68, pos=(0.0049166, 0.00762615, -8.865e-05),
               quat=(0.495027, 0.482891, 0.507341, 0.514169),
               diaginertia=(0.000734064, 0.000468438, 0.000398719)),
    "RL": dict(mass=0.68, pos=(0.0049166, -0.00762615, -8.865e-05),
               quat=(0.514169, 0.507341, 0.482891, 0.495027),
               diaginertia=(0.000734064, 0.000468438, 0.000398719)),
}
THIGH_INERTIAL = {
    "R": dict(mass=1.009, pos=(-0.00304722, 0.019315, -0.0305004),
              quat=(0.65243, -0.0272313, 0.0775126, 0.753383),
              diaginertia=(0.00478717, 0.00460903, 0.000709268)),
    "L": dict(mass=1.009, pos=(-0.00304722, -0.019315, -0.0305004),
              quat=(0.753383, 0.0775126, -0.0272313, 0.65243),
              diaginertia=(0.00478717, 0.00460903, 0.000709268)),
}
CALF_INERTIAL = dict(
    mass=0.195862, pos=(0.00429862, 0.000976676, -0.146197),
    quat=(0.691246, 0.00357467, 0.00511118, 0.722592),
    diaginertia=(0.00149767, 0.00148468, 3.58427e-05),
)

# Joint parameters (go1.xml:9-22).
ABDUCTION = dict(axis=(1, 0, 0), range=(-0.863, 0.863), damping=1.0,
                 armature=0.01, frictionloss=0.2)
HIP = dict(axis=(0, 1, 0), range=(-0.686, 4.501), damping=2.0,
           armature=0.01, frictionloss=0.2)
KNEE = dict(axis=(0, 1, 0), range=(-2.818, -0.888), damping=2.0,
            armature=0.01, frictionloss=0.2)
KP = 100.0
FORCERANGE = (-23.7, 23.7)
KNEE_FORCERANGE = (-35.55, 35.55)

# Collision primitives (go1.xml:26-65,86-94) as (type, size, pos, quat|fromto).
TRUNK_COLLISION = [
    ("box", (0.125, 0.04, 0.057), (0, 0, 0), (1, 0, 0, 0)),
    ("cylinder", (0.058, 0.125), (0, -0.04, 0), (1, 0, 1, 0)),
    ("cylinder", (0.058, 0.125), (0, 0.04, 0), (1, 0, 1, 0)),
    ("box", (0.005, 0.06, 0.05), (0.25, 0, 0), (1, 0, 0, 0)),
    ("capsule", (0.009, 0.035), (0.25, 0.06, -0.01), (1, 0, 0, 0)),
    ("capsule", (0.009, 0.035), (0.25, -0.06, -0.01), (1, 0, 0, 0)),
    ("capsule", (0.01, 0.06), (0.25, 0, -0.05), (1, 1, 0, 0)),
    ("capsule", (0.021, 0.052), (0.255, 0, 0.0355), (1, 1, 0, 0)),
]
HIP_COLLISION = {  # per side; rear legs add the hip3 cylinder at the origin
    "R": [("cylinder", (0.046, 0.02), (0, -0.045, 0), (1, 1, 0, 0)),
          ("cylinder", (0.031, 0.02), (0, -0.065, 0), (1, 1, 0, 0))],
    "L": [("cylinder", (0.046, 0.02), (0, 0.045, 0), (1, 1, 0, 0)),
          ("cylinder", (0.031, 0.02), (0, 0.065, 0), (1, 1, 0, 0))],
}
HIP3 = ("cylinder", (0.046, 0.02), (0, 0, 0), (1, 1, 0, 0))
THIGH_COLLISION = [  # fromto capsules (go1.xml:46-54)
    ("capsule_ft", 0.015, (-0.02, 0, 0, -0.02, 0, -0.16)),
    ("capsule_ft", 0.015, (0, 0, 0, -0.02, 0, -0.1)),
    ("capsule_ft", 0.015, (-0.02, 0, -0.16, 0, 0, -0.2)),
]
CALF_COLLISION = [
    ("capsule_ft", 0.01, (0, 0, 0, 0.02, 0, -0.13)),
    ("capsule_ft", 0.01, (0.02, 0, -0.13, 0, 0, -0.2)),
]

KEYFRAMES = {  # go1.xml:224-228
    "home": dict(height=0.27, joints=(0.0, 0.9, -1.8)),
    "descent": dict(height=0.6, joints=(0.0, 0.9, -1.8)),
}
LEG_ORDER = ("FR", "FL", "RR", "RL")
ACTUATOR_NAMES = [f"{leg}_{p}" for leg in LEG_ORDER for p in ("hip", "thigh", "calf")]

JUMP_OBSTACLE = dict(pos=(1.0, 0.0, 0.09), size=(0.4, 0.4, 0.09))      # jump_scene.xml:26-28
LANDING_OBSTACLE = dict(pos=(0.0, 0.0, 0.2), size=(0.4, 0.4, 0.2))     # landing_scene.xml:25-27


def _fmt(v):
    return " ".join(f"{x:.9g}" for x in v)


def _geom(spec, friction=BODY_FRICTION, name=""):
    nm = f' name="{name}"' if name else ""
    if spec[0] == "capsule_ft":
        _, r, ft = spec
        return (f'<geom{nm} type="capsule" size="{r}" fromto="{_fmt(ft)}" '
                f'friction="{_fmt(friction)}"/>')
    t, size, pos, quat = spec
    return (f'<geom{nm} type="{t}" size="{_fmt(size)}" pos="{_fmt(pos)}" '
            f'quat="{_fmt(quat)}" friction="{_fmt(friction)}"/>')


def _joint(name, p):
    return (f'<joint name="{name}" type="hinge" axis="{_fmt(p["axis"])}" '
            f'range="{_fmt(p["range"])}" damping="{p["damping"]}" '
            f'armature="{p["armature"]}" frictionloss="{p["frictionloss"]}"/>')


def _inertial(i):
    return (f'<inertial mass="{i["mass"]}" pos="{_fmt(i["pos"])}" '
            f'quat="{_fmt(i["quat"])}" diaginertia="{_fmt(i["diaginertia"])}"/>')


def _leg_xml(leg: str) -> str:
    hip_pos, thigh_pos = LEG_POS[leg]
    side = "R" if leg.endswith("R") else "L"
    hip_coll = list(HIP_COLLISION[side])
    if leg.startswith("R"):
        hip_coll.append(HIP3)
    hip_geoms = "\n        ".join(_geom(g) for g in hip_coll)
    thigh_geoms = "\n          ".join(_geom(g) for g in THIGH_COLLISION)
    calf_geoms = "\n            ".join(_geom(g) for g in CALF_COLLISION)
    return f"""
      <body name="{leg}_hip" pos="{_fmt(hip_pos)}">
        {_inertial(HIP_INERTIAL[leg])}
        {_joint(f"{leg}_hip_joint", ABDUCTION)}
        {hip_geoms}
        <body name="{leg}_thigh" pos="{_fmt(thigh_pos)}">
          {_inertial(THIGH_INERTIAL[side])}
          {_joint(f"{leg}_thigh_joint", HIP)}
          {thigh_geoms}
          <body name="{leg}_calf" pos="{_fmt(CALF_POS)}">
            {_inertial(CALF_INERTIAL)}
            {_joint(f"{leg}_calf_joint", KNEE)}
            {calf_geoms}
            <geom name="{leg}" type="sphere" size="{FOOT_RADIUS}" pos="{_fmt(FOOT_POS)}" friction="{_fmt(FOOT_FRICTION)}" solref="{_fmt(FOOT_SOLREF)}"/>
            <site name="{leg}" pos="{_fmt(FOOT_POS)}"/>
          </body>
        </body>
      </body>"""


def go1_xml(scene: str = "flat") -> str:
    """Generate the Go1 MJCF.  ``scene``: 'flat' | 'jump' | 'landing' | 'none'."""
    if scene not in ("flat", "jump", "landing", "none"):
        raise ValueError(
            f"unknown scene {scene!r}: use 'flat'|'jump'|'landing'|'none'"
        )
    legs = "".join(_leg_xml(leg) for leg in LEG_ORDER)
    trunk_geoms = "\n      ".join(_geom(g) for g in TRUNK_COLLISION)
    actuators = "\n".join(
        f'    <position name="{leg}_{p}" joint="{leg}_{p}_joint" kp="{KP}" '
        f'forcerange="{_fmt(KNEE_FORCERANGE if p == "calf" else FORCERANGE)}" '
        f'ctrlrange="{_fmt((KNEE if p == "calf" else HIP if p == "thigh" else ABDUCTION)["range"])}"/>'
        for leg in LEG_ORDER
        for p in ("hip", "thigh", "calf")
    )
    keys = "\n".join(
        f'    <key name="{name}" qpos="0 0 {k["height"]} 1 0 0 0 '
        + " ".join(_fmt(k["joints"]) for _ in range(4))
        + '" ctrl="' + " ".join(_fmt(k["joints"]) for _ in range(4)) + '"/>'
        for name, k in KEYFRAMES.items()
    )
    world = ""
    if scene in ("flat", "jump", "landing"):
        world = '    <geom name="floor" type="plane" size="0 0 0.05"/>'
    if scene == "jump":
        o = JUMP_OBSTACLE
        world += (f'\n    <body name="obstacle" pos="{_fmt(o["pos"])}">'
                  f'<geom name="obstacle" type="box" size="{_fmt(o["size"])}"/></body>')
    elif scene == "landing":
        o = LANDING_OBSTACLE
        world += (f'\n    <body name="obstacle" pos="{_fmt(o["pos"])}">'
                  f'<geom name="obstacle" type="box" size="{_fmt(o["size"])}"/></body>')
    return f"""<mujoco model="go1_tpu">
  <compiler angle="radian" autolimits="true"/>
  <option gravity="0 0 -9.81" timestep="0.002"/>
  <worldbody>
{world}
    <body name="trunk" pos="0 0 0.445">
      {_inertial(TRUNK_INERTIAL)}
      <freejoint/>
      <site name="head" pos="0.3 0 0"/>
      <site name="imu" pos="0 0 0"/>
      {trunk_geoms}
{legs}
    </body>
  </worldbody>
  <actuator>
{actuators}
  </actuator>
  <keyframe>
{keys}
  </keyframe>
</mujoco>
"""
