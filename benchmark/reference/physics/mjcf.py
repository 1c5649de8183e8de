# Frozen copy of opendog_tpu_torch/physics/mjcf.py at commit 9b29168 (the benchmark's reference:
# later changes to the program do not reach it).  Imports rewritten only.
"""MJCF ingestion → :class:`opendog_tpu_torch.physics.model.Model`.

Port of ``opendog_tpu/physics/mjcf.py``: the parser is the same numpy code;
only :func:`build_model` differs, handing its float32 / int32 tables to
:func:`.model.model_from_arrays`, which places them on one device.

Covers the subset of MJCF used by the reference robot models
(`Code/mujoco/our_robot/our_robot.xml`,
`Code/mujoco/unitree_go1/go1.xml` and their scene files):
includes, nested default classes with ``childclass`` propagation, free/hinge
joints, explicit ``<inertial>`` or geom-derived inertia (mesh mass properties
computed from the STL via signed-tetrahedron integration), position actuators,
keyframes, sites, plane/hfield/box world geometry.

Collision canonicalisation (TPU-first): every collidable geom is reduced to
one or more *spheres* in the body frame —
  * sphere → itself,
  * capsule / cylinder → two endpoint spheres,
  * box on a robot body → inscribed sphere,
  * mesh → a support sphere at the mesh centroid whose lowest point matches
    the mesh's lowest vertex at the ``home`` keyframe (so the standing height
    of the home pose matches the reference model — the trunk healthy z-range
    the rewards check is (0.04, 0.11), reference
    ``rewards/walk_environment_reward_calc.py:86``).
This gives a single fully-vectorised sphere-vs-ground contact path.

Pure numpy at load time; the result is a Model of tensors on one device.
"""
from __future__ import annotations

import os
import struct as _struct
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

import numpy as np

from .._device import resolve_device
from .model import JNT_FREE, JNT_HINGE, JNT_NONE, Model, model_from_arrays

# ---------------------------------------------------------------------------
# small numpy quaternion helpers (wxyz)
# ---------------------------------------------------------------------------


def np_quat_to_mat(q):
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def np_quat_mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ]
    )


def _axis_angle_quat(axis, angle):
    axis = np.asarray(axis, dtype=np.float64)
    n = np.linalg.norm(axis)
    if n < 1e-12:
        return np.array([1.0, 0, 0, 0])
    axis = axis / n
    return np.concatenate([[np.cos(angle / 2)], axis * np.sin(angle / 2)])


def _parse_floats(s: Optional[str], n: Optional[int] = None, default=None):
    if s is None:
        return default
    v = np.array([float(x) for x in s.split()], dtype=np.float64)
    if n is not None and v.size != n:
        raise ValueError(f"expected {n} floats, got {s!r}")
    return v


# ---------------------------------------------------------------------------
# STL loading + mass properties
# ---------------------------------------------------------------------------


def load_stl(path: str) -> np.ndarray:
    """Return (ntri, 3, 3) triangle vertices from a binary or ascii STL."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) >= 84:
        (count,) = _struct.unpack_from("<I", data, 80)
        if 84 + 50 * count == len(data):
            rec = np.frombuffer(
                data[84:],
                dtype=np.dtype([("n", "<3f4"), ("v", "<(3,3)f4"), ("attr", "<u2")]),
                count=count,
            )
            return rec["v"].astype(np.float64)
    verts: List[List[float]] = []
    for line in data.decode("ascii", errors="ignore").splitlines():
        parts = line.split()
        if parts[:1] == ["vertex"]:
            verts.append([float(x) for x in parts[1:4]])
    return np.array(verts, dtype=np.float64).reshape(-1, 3, 3)


def mesh_mass_properties(tris: np.ndarray, mass: float):
    """(com, inertia_about_com) of a closed triangle mesh with total ``mass``.

    Signed-tetrahedron integration (divergence theorem); falls back to a
    vertex point-cloud approximation for non-watertight meshes.
    """
    a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
    vol6 = np.einsum("ij,ij->i", a, np.cross(b, c))
    volume = vol6.sum() / 6.0
    verts = tris.reshape(-1, 3)
    bbox_vol = float(np.prod(verts.max(0) - verts.min(0))) + 1e-18
    if abs(volume) < 1e-4 * bbox_vol:
        com = verts.mean(0)
        d = verts - com
        per_mass = mass / len(verts)
        inertia = per_mass * (np.eye(3) * (d * d).sum() - d.T @ d)
        return com, inertia
    com = (vol6[:, None] * (a + b + c)).sum(0) / (4.0 * vol6.sum())

    def _second(aa, bb, cc):
        s = aa + bb + cc
        return (
            np.einsum("ni,nj->nij", s, s)
            + np.einsum("ni,nj->nij", aa, aa)
            + np.einsum("ni,nj->nij", bb, bb)
            + np.einsum("ni,nj->nij", cc, cc)
        )

    P = (vol6[:, None, None] / 120.0 * _second(a, b, c)).sum(0)
    P = (mass / volume) * P
    I_origin = np.eye(3) * np.trace(P) - P
    d = com
    I_com = I_origin - mass * (np.eye(3) * (d @ d) - np.outer(d, d))
    return com, 0.5 * (I_com + I_com.T)


def _primitive_inertia(gtype: str, size: np.ndarray, mass: float):
    if gtype == "sphere":
        r = size[0]
        return np.diag([0.4 * mass * r * r] * 3)
    if gtype == "capsule":
        r, h = size[0], size[1]
        m_cyl = mass * (2 * h) / (2 * h + 4.0 / 3.0 * r)
        m_sph = mass - m_cyl
        izz = 0.5 * m_cyl * r * r + 0.4 * m_sph * r * r
        ixx = m_cyl * (r * r / 4 + h * h / 3) + m_sph * (
            0.4 * r * r + h * h + 0.75 * r * h
        )
        return np.diag([ixx, ixx, izz])
    if gtype == "cylinder":
        r, h = size[0], size[1]
        return np.diag(
            [mass * (3 * r * r + 4 * h * h) / 12.0] * 2 + [0.5 * mass * r * r]
        )
    if gtype == "box":
        x, y, z = size[:3]
        return mass / 3.0 * np.diag([y * y + z * z, x * x + z * z, x * x + y * y])
    raise ValueError(f"no inertia formula for geom type {gtype}")


# ---------------------------------------------------------------------------
# defaults resolution
# ---------------------------------------------------------------------------


class _Defaults:
    """MJCF default-class tree: class name -> tag -> attr dict."""

    def __init__(self):
        self.classes: Dict[str, Dict[str, Dict[str, str]]] = {"": {}}
        self.parent: Dict[str, str] = {}

    def add(self, elem: ET.Element, parent_cls: str = ""):
        cls = elem.get("class", "" if parent_cls == "" else None)
        if cls is None:
            raise ValueError("nested default without class name")
        self.parent[cls] = parent_cls
        table = self.classes.setdefault(cls, {})
        for child in elem:
            if child.tag == "default":
                self.add(child, cls)
            else:
                table.setdefault(child.tag, {}).update(child.attrib)

    def resolve(self, tag: str, elem: ET.Element, active_cls: str) -> Dict[str, str]:
        cls = elem.get("class", active_cls)
        chain = []
        c = cls
        while True:
            chain.append(c)
            if c == "":
                break
            c = self.parent.get(c, "")
        attrs: Dict[str, str] = {}
        for c in reversed(chain):
            attrs.update(self.classes.get(c, {}).get(tag, {}))
        attrs.update(elem.attrib)
        return attrs


# ---------------------------------------------------------------------------
# intermediate build structures
# ---------------------------------------------------------------------------


class _Body:
    def __init__(self, name, parent, pos, quat):
        self.name = name
        self.parent = parent  # index or -1 for world children
        self.pos = pos
        self.quat = quat
        self.jnt_type = JNT_NONE
        self.jnt_name = ""
        self.jnt_axis = np.array([0.0, 0, 1])
        self.jnt_pos = np.zeros(3)
        self.jnt_range = np.array([-np.inf, np.inf])
        self.jnt_limited = False
        self.armature = 0.0
        self.damping = 0.0
        self.frictionloss = 0.0
        self.explicit_inertial = None  # (mass, com, I_com)
        self.geom_inertias: List[Tuple[float, np.ndarray, np.ndarray]] = []


def _resolve_includes(path: str, root: ET.Element) -> None:
    base = os.path.dirname(path)
    changed = True
    while changed:
        changed = False
        for parent in list(root.iter()):
            for i, child in enumerate(list(parent)):
                if child.tag == "include":
                    sub = ET.parse(os.path.join(base, child.get("file"))).getroot()
                    parent.remove(child)
                    for j, sc in enumerate(list(sub)):
                        parent.insert(i + j, sc)
                    changed = True


def load_model(source: str, device=None, **overrides) -> Model:
    """Parse MJCF into a :class:`Model` whose tensors live on ``device``
    (CUDA unless the caller names another).

    ``source`` is either a filesystem path or an XML string (detected by a
    leading ``<``).  ``overrides`` may set contact/solver parameters.
    """
    if source.lstrip().startswith("<"):
        root = ET.fromstring(source)
        base_dir = os.getcwd()
    else:
        root = ET.parse(source).getroot()
        _resolve_includes(source, root)
        base_dir = os.path.dirname(os.path.abspath(source))

    meshdir = "assets"
    for compiler in root.findall("compiler"):
        meshdir = compiler.get("meshdir", meshdir)
    mesh_root = os.path.join(base_dir, meshdir)

    gravity = np.array([0.0, 0.0, -9.81])
    timestep = 0.002
    for opt in root.findall("option"):
        g = _parse_floats(opt.get("gravity"), 3)
        if g is not None:
            gravity = g
        if opt.get("timestep"):
            timestep = float(opt.get("timestep"))

    defaults = _Defaults()
    for d in root.findall("default"):
        defaults.add(d, "")

    # ---- assets ----
    meshes: Dict[str, np.ndarray] = {}
    hfield_spec = None
    for asset in root.findall("asset"):
        for m in asset.findall("mesh"):
            attrs = defaults.resolve("mesh", m, "")
            fname = attrs.get("file")
            name = attrs.get("name", os.path.splitext(os.path.basename(fname))[0])
            scale = _parse_floats(attrs.get("scale"), 3, np.ones(3))
            meshes[name] = load_stl(os.path.join(mesh_root, fname)) * scale
        for h in asset.findall("hfield"):
            hfield_spec = dict(
                nrow=int(h.get("nrow")),
                ncol=int(h.get("ncol")),
                size=_parse_floats(h.get("size"), 4),
            )

    bodies: List[_Body] = []
    sites: List[Tuple[str, int, np.ndarray]] = []
    world_boxes: List[Tuple[np.ndarray, np.ndarray]] = []
    has_plane = False
    has_hfield_geom = False
    geom_meta: List[dict] = []

    def add_sphere(body_idx, pos, radius, friction, name, mesh_verts=None,
                   solref=None, solimp=None):
        # MJCF "direct" convention: solref="-k -d" sets an explicit contact
        # stiffness/damping (used by go1.xml-style soft foot pads)
        k = d = None
        if solref is not None and solref[0] < 0:
            k, d = -solref[0], -solref[1]
        # solimp="dmin dmax width [...]": progressive contact impedance —
        # force ramps from dmin*k*pen at touchdown to k*pen at pen >= width
        # (power-1 approximation of MuJoCo's sigmoid; op-graph engine only,
        # see physics/dynamics.contact_terms and model.geom_imp_dmin)
        imp_dmin = imp_width = None
        if solimp is not None:
            imp_dmin, imp_width = float(solimp[0]), float(solimp[2])
        geom_meta.append(
            dict(body=body_idx, pos=np.asarray(pos, dtype=np.float64),
                 radius=float(radius), friction=friction, name=name,
                 mesh_verts=mesh_verts, stiffness=k, damping=d,
                 imp_dmin=imp_dmin, imp_width=imp_width)
        )

    def handle_geom(attrs: Dict[str, str], body_idx: Optional[int],
                    body: Optional[_Body], static_offset: np.ndarray):
        nonlocal has_plane, has_hfield_geom
        gtype = attrs.get("type", "sphere")
        if gtype == "plane":
            has_plane = True
            return
        if gtype == "hfield":
            has_hfield_geom = True
            return
        pos = _parse_floats(attrs.get("pos"), 3, np.zeros(3))
        quat = _parse_floats(attrs.get("quat"), 4, np.array([1.0, 0, 0, 0]))
        quat = quat / np.linalg.norm(quat)
        size = np.atleast_1d(_parse_floats(attrs.get("size"), None, np.zeros(3)))
        contype = int(attrs.get("contype", "1"))
        conaffinity = int(attrs.get("conaffinity", "1"))
        friction_in = _parse_floats(attrs.get("friction"), None,
                                    np.array([1.0, 0.005, 0.0001]))
        fr = np.array(
            [friction_in[0] if friction_in.size > 0 else 1.0,
             friction_in[1] if friction_in.size > 1 else 0.005,
             friction_in[2] if friction_in.size > 2 else 0.0001]
        )
        mass = attrs.get("mass")
        name = attrs.get("name", "")
        fromto = _parse_floats(attrs.get("fromto"), 6)
        solref = _parse_floats(attrs.get("solref"), 2)
        solimp = _parse_floats(attrs.get("solimp"), 3)

        if body is None:
            if gtype == "box":
                world_boxes.append((static_offset + pos, size[:3].copy()))
            return

        collidable = contype != 0 or conaffinity != 0
        if contype == 0 and conaffinity == 0:
            collidable = False

        if gtype == "mesh":
            tris = meshes[attrs["mesh"]]
            if mass is not None:
                com_m, I_m = mesh_mass_properties(tris, float(mass))
                R = np_quat_to_mat(quat)
                body.geom_inertias.append(
                    (float(mass), pos + R @ com_m, R @ I_m @ R.T)
                )
            if collidable:
                verts = tris.reshape(-1, 3)
                R = np_quat_to_mat(quat)
                verts_b = verts @ R.T + pos
                centroid = verts_b.mean(0)
                brad = float(np.linalg.norm(verts_b - centroid, axis=1).max())
                add_sphere(body_idx, centroid, brad, fr, name, mesh_verts=verts_b, solref=solref, solimp=solimp)
            return

        if gtype in ("capsule", "cylinder") and fromto is not None:
            # MuJoCo fromto form: size = (radius,); derive the frame from
            # the segment (mjcf 'fromto' semantics)
            p1f, p2f = fromto[:3], fromto[3:]
            seg = p2f - p1f
            hl = float(np.linalg.norm(seg)) / 2.0
            pos = (p1f + p2f) / 2.0
            z = seg / max(np.linalg.norm(seg), 1e-12)
            # quat rotating +z onto the segment axis
            c = float(np.clip(z[2], -1.0, 1.0))
            if c > 1.0 - 1e-9:
                quat = np.array([1.0, 0, 0, 0])
            elif c < -1.0 + 1e-9:
                quat = np.array([0.0, 1.0, 0, 0])
            else:
                ax = np.cross([0.0, 0, 1], z)
                ax = ax / np.linalg.norm(ax)
                half = np.arccos(c) / 2.0
                quat = np.array([np.cos(half), *(np.sin(half) * ax)])
            size = np.array([float(size[0]), hl, 0.0])
        if mass is not None and gtype in ("sphere", "capsule", "cylinder", "box"):
            m = float(mass)
            I = _primitive_inertia(gtype, size, m)
            R = np_quat_to_mat(quat)
            body.geom_inertias.append((m, pos.copy(), R @ I @ R.T))
        if not collidable:
            return
        if gtype == "sphere":
            add_sphere(body_idx, pos, size[0], fr, name, solref=solref, solimp=solimp)
        elif gtype in ("capsule", "cylinder"):
            if fromto is not None:
                p1, p2, r = fromto[:3], fromto[3:], float(size[0])
            else:
                R = np_quat_to_mat(quat)
                axis = R @ np.array([0.0, 0, 1])
                hl = float(size[1])
                p1, p2, r = pos - axis * hl, pos + axis * hl, float(size[0])
            add_sphere(body_idx, p1, r, fr, name, solref=solref, solimp=solimp)
            add_sphere(body_idx, p2, r, fr, name, solref=solref, solimp=solimp)
        elif gtype == "box":
            add_sphere(body_idx, pos, float(np.min(size[:3])), fr, name, solref=solref, solimp=solimp)

    def walk(elem: ET.Element, parent_idx: Optional[int], active_cls: str,
             parent_static: bool, static_offset: np.ndarray):
        childclass = elem.get("childclass", active_cls)
        has_joint = (
            elem.find("joint") is not None or elem.find("freejoint") is not None
        )
        is_static = parent_static and not has_joint
        body_idx = None
        pos = _parse_floats(elem.get("pos"), 3, np.zeros(3))
        if is_static:
            static_offset = static_offset + pos
        else:
            quat = _parse_floats(elem.get("quat"), 4, np.array([1.0, 0, 0, 0]))
            quat = quat / np.linalg.norm(quat)
            b = _Body(elem.get("name", f"body{len(bodies)}"),
                      -1 if (parent_idx is None or parent_static) else parent_idx,
                      pos, quat)
            bodies.append(b)
            body_idx = len(bodies) - 1
        cur_body = bodies[body_idx] if body_idx is not None else None

        for child in elem:
            if child.tag == "joint" and cur_body is not None:
                attrs = defaults.resolve("joint", child, childclass)
                jt = attrs.get("type", "hinge")
                if jt == "free":
                    cur_body.jnt_type = JNT_FREE
                    # MuJoCo lets free joints inherit armature/frictionloss
                    # from default classes (the reference our_robot.xml does
                    # exactly this: all 14 dofs get armature .02 / loss .1)
                    cur_body.armature = float(attrs.get("armature", 0.0))
                    cur_body.damping = float(attrs.get("damping", 0.0))
                    cur_body.frictionloss = float(attrs.get("frictionloss", 0.0))
                else:
                    cur_body.jnt_type = JNT_HINGE
                    cur_body.jnt_axis = _parse_floats(
                        attrs.get("axis"), 3, np.array([0.0, 0, 1])
                    )
                    cur_body.jnt_pos = _parse_floats(attrs.get("pos"), 3, np.zeros(3))
                    rng = _parse_floats(attrs.get("range"), 2)
                    if rng is not None:
                        cur_body.jnt_range = rng
                        cur_body.jnt_limited = True
                    cur_body.armature = float(attrs.get("armature", 0.0))
                    cur_body.damping = float(attrs.get("damping", 0.0))
                    cur_body.frictionloss = float(attrs.get("frictionloss", 0.0))
                cur_body.jnt_name = child.get("name", f"{cur_body.name}_joint")
            elif child.tag == "freejoint" and cur_body is not None:
                cur_body.jnt_type = JNT_FREE
                cur_body.jnt_name = child.get("name", f"{cur_body.name}_free")
            elif child.tag == "geom":
                attrs = defaults.resolve("geom", child, childclass)
                handle_geom(attrs, body_idx, cur_body, static_offset)
            elif child.tag == "inertial" and cur_body is not None:
                mass = float(child.get("mass"))
                ipos = _parse_floats(child.get("pos"), 3, np.zeros(3))
                iquat = _parse_floats(child.get("quat"), 4, np.array([1.0, 0, 0, 0]))
                iquat = iquat / np.linalg.norm(iquat)
                diag = _parse_floats(child.get("diaginertia"), 3)
                R = np_quat_to_mat(iquat)
                cur_body.explicit_inertial = (mass, ipos, R @ np.diag(diag) @ R.T)
            elif child.tag == "site" and cur_body is not None:
                spos = _parse_floats(child.get("pos"), 3, np.zeros(3))
                sites.append((child.get("name", f"site{len(sites)}"), body_idx, spos))
            elif child.tag == "body":
                walk(child, body_idx, childclass, is_static, static_offset)

    for wb in root.findall("worldbody"):
        for child in wb:
            if child.tag == "geom":
                attrs = defaults.resolve("geom", child, "")
                handle_geom(attrs, None, None, np.zeros(3))
            elif child.tag == "body":
                walk(child, None, child.get("childclass", ""), True, np.zeros(3))

    nb = len(bodies)

    # ---- addressing ----
    body_qpos_adr, body_dof_adr, joint_names = [], [], []
    nq = nv = 0
    dof_body: List[int] = []
    for i, b in enumerate(bodies):
        body_qpos_adr.append(nq)
        body_dof_adr.append(nv)
        joint_names.append(b.jnt_name)
        if b.jnt_type == JNT_FREE:
            nq += 7
            nv += 6
            dof_body += [i] * 6
        elif b.jnt_type == JNT_HINGE:
            nq += 1
            nv += 1
            dof_body += [i]

    dof_armature = np.zeros(nv)
    dof_damping = np.zeros(nv)
    dof_frictionloss = np.zeros(nv)
    dof_limited = np.zeros(nv)
    dof_range = np.tile(np.array([-1e9, 1e9]), (nv, 1))
    for i, b in enumerate(bodies):
        d = body_dof_adr[i]
        if b.jnt_type == JNT_FREE:
            dof_armature[d : d + 6] = b.armature
            dof_damping[d : d + 6] = b.damping
            dof_frictionloss[d : d + 6] = b.frictionloss
        elif b.jnt_type == JNT_HINGE:
            dof_armature[d] = b.armature
            dof_damping[d] = b.damping
            dof_frictionloss[d] = b.frictionloss
            if b.jnt_limited:
                dof_limited[d] = 1.0
                dof_range[d] = b.jnt_range

    ancestor_mask = np.zeros((nb, nv))
    for i, b in enumerate(bodies):
        j = i
        while j >= 0:
            bj = bodies[j]
            d = body_dof_adr[j]
            if bj.jnt_type == JNT_FREE:
                ancestor_mask[i, d : d + 6] = 1.0
            elif bj.jnt_type == JNT_HINGE:
                ancestor_mask[i, d] = 1.0
            j = bj.parent

    body_mass = np.zeros(nb)
    body_com = np.zeros((nb, 3))
    body_inertia = np.zeros((nb, 3, 3))
    for i, b in enumerate(bodies):
        if b.explicit_inertial is not None:
            m, c, I = b.explicit_inertial
        elif b.geom_inertias:
            m = sum(g[0] for g in b.geom_inertias)
            c = sum(g[0] * g[1] for g in b.geom_inertias) / m
            I = np.zeros((3, 3))
            for gm, gc, gI in b.geom_inertias:
                d = gc - c
                I += gI + gm * (np.eye(3) * (d @ d) - np.outer(d, d))
        else:
            m, c, I = 1e-6, np.zeros(3), np.eye(3) * 1e-10
        body_mass[i] = m
        body_com[i] = c
        body_inertia[i] = I

    # ---- actuators ----
    act_names, act_dof, act_qposadr, act_kp, act_kv = [], [], [], [], []
    act_cr, act_fr = [], []
    jnt_name_to_body = {b.jnt_name: i for i, b in enumerate(bodies)}
    for act_root in root.findall("actuator"):
        for a in act_root:
            if a.tag != "position":
                continue
            attrs = defaults.resolve("position", a, "")
            bi = jnt_name_to_body[attrs.get("joint")]
            act_names.append(attrs.get("name", f"{attrs.get('joint')}_act"))
            act_dof.append(body_dof_adr[bi])
            act_qposadr.append(body_qpos_adr[bi])
            act_kp.append(float(attrs.get("kp", 1.0)))
            act_kv.append(float(attrs.get("kv", 0.0)))
            act_cr.append(_parse_floats(attrs.get("ctrlrange"), 2,
                                        np.array([-1e9, 1e9])))
            act_fr.append(_parse_floats(attrs.get("forcerange"), 2,
                                        np.array([-1e9, 1e9])))
    nu = len(act_names)

    # ---- keyframes ----
    key_names, key_qpos, key_ctrl = [], [], []
    for kf in root.findall("keyframe"):
        for k in kf.findall("key"):
            key_names.append(k.get("name", f"key{len(key_names)}"))
            key_qpos.append(_parse_floats(k.get("qpos"), nq, np.zeros(nq)))
            key_ctrl.append(_parse_floats(k.get("ctrl"), nu, np.zeros(nu)))
    for q in key_qpos:
        for i, b in enumerate(bodies):
            if b.jnt_type == JNT_FREE:
                adr = body_qpos_adr[i]
                quat = q[adr + 3 : adr + 7]
                n = np.linalg.norm(quat)
                q[adr + 3 : adr + 7] = [1.0, 0, 0, 0] if n < 1e-8 else quat / n

    # ---- mesh support-sphere calibration at the home keyframe ----
    if key_qpos:
        idx = key_names.index("home") if "home" in key_names else 0
        xpos, xquat = _np_fk(bodies, body_qpos_adr, key_qpos[idx])
        for g in geom_meta:
            verts = g.pop("mesh_verts", None)
            if verts is None:
                continue
            bi = g["body"]
            R = np_quat_to_mat(xquat[bi])
            vw = verts @ R.T + xpos[bi]
            cz = (R @ g["pos"] + xpos[bi])[2]
            g["radius"] = float(max(cz - vw[:, 2].min(), 1e-3))
    else:
        for g in geom_meta:
            g.pop("mesh_verts", None)

    ng = len(geom_meta)

    # ---- foot identification ----
    foot_body: List[int] = []
    foot_geom: List[int] = []
    for gi, g in enumerate(geom_meta):
        bname = bodies[g["body"]].name.lower()
        gname = (g["name"] or "").lower()
        if "paw" in bname or gname in ("fr", "fl", "rr", "rl"):
            if g["body"] not in foot_body:
                foot_body.append(g["body"])
            foot_geom.append(gi)

    return build_model(
        bodies=bodies,
        nq=nq, nv=nv, nu=nu,
        body_qpos_adr=body_qpos_adr, body_dof_adr=body_dof_adr,
        dof_body=dof_body, joint_names=joint_names,
        dof_armature=dof_armature, dof_damping=dof_damping,
        dof_frictionloss=dof_frictionloss, dof_limited=dof_limited,
        dof_range=dof_range, ancestor_mask=ancestor_mask,
        body_mass=body_mass, body_com=body_com, body_inertia=body_inertia,
        act_names=act_names, act_dof=act_dof, act_qposadr=act_qposadr,
        act_kp=act_kp, act_kv=act_kv, act_cr=act_cr, act_fr=act_fr,
        geom_meta=geom_meta, world_boxes=world_boxes, sites=sites,
        key_names=key_names, key_qpos=key_qpos, key_ctrl=key_ctrl,
        foot_body=foot_body, foot_geom=foot_geom,
        gravity=gravity, timestep=timestep,
        has_plane=has_plane or not has_hfield_geom,
        hfield_spec=hfield_spec, device=device, **overrides,
    )


def build_model(
    *, bodies, nq, nv, nu, body_qpos_adr, body_dof_adr, dof_body, joint_names,
    dof_armature, dof_damping, dof_frictionloss, dof_limited, dof_range,
    ancestor_mask, body_mass, body_com, body_inertia, act_names, act_dof,
    act_qposadr, act_kp, act_kv, act_cr, act_fr, geom_meta, world_boxes, sites,
    key_names, key_qpos, key_ctrl, foot_body, foot_geom, gravity, timestep,
    has_plane, hfield_spec, device=None,
    contact_stiffness=None, contact_damping=None,
    friction_smoothing=0.005, limit_stiffness=300.0, limit_damping=3.0,
) -> Model:
    """Assemble a :class:`Model` from build tables (shared by the MJCF parser
    and the programmatic robot descriptions in :mod:`opendog_tpu_torch.assets`).
    Every float table is rounded to float32 from float64, as in the JAX
    loader, before it becomes a tensor on ``device``."""
    nb = len(bodies)
    ng = len(geom_meta)
    total_mass = float(np.sum(body_mass))
    nfeet = max(len(foot_body), 1)
    if contact_stiffness is None:
        # near-rigid (impratio=100) approximation: ~1 mm static penetration
        # with half the feet loaded
        contact_stiffness = total_mass * 9.81 / max(nfeet // 2, 1) / 1e-3
    if contact_damping is None:
        contact_damping = 2.0 * np.sqrt(contact_stiffness * total_mass / nfeet)

    f64 = lambda x: np.asarray(x, dtype=np.float64)
    static = dict(
        nq=nq, nv=nv, nu=nu, nbody=nb, ngeom=ng, nsite=len(sites),
        body_names=tuple(b.name for b in bodies),
        joint_names=tuple(joint_names),
        actuator_names=tuple(act_names),
        site_names=tuple(s[0] for s in sites),
        key_names=tuple(key_names),
        body_parent=tuple(b.parent for b in bodies),
        jnt_type=tuple(b.jnt_type for b in bodies),
        body_qpos_adr=tuple(body_qpos_adr),
        body_dof_adr=tuple(body_dof_adr),
        dof_body=tuple(dof_body),
        site_body=tuple(s[1] for s in sites),
        foot_body=tuple(foot_body),
        foot_geom=tuple(foot_geom),
        geom_body_static=tuple(int(g["body"]) for g in geom_meta),
        timestep=float(timestep),
        has_plane=bool(has_plane),
        hfield_nrow=hfield_spec["nrow"] if hfield_spec else 0,
        hfield_ncol=hfield_spec["ncol"] if hfield_spec else 0,
    )
    has_imp_dmin = any(g.get("imp_dmin") is not None for g in geom_meta)
    has_imp_width = any(g.get("imp_width") is not None for g in geom_meta)
    arrays = dict(
        body_pos=f64(np.stack([b.pos for b in bodies])),
        body_quat=f64(np.stack([b.quat for b in bodies])),
        body_mass=f64(body_mass),
        body_com=f64(body_com),
        body_inertia=f64(body_inertia),
        jnt_axis=f64(np.stack([
            b.jnt_axis / max(np.linalg.norm(b.jnt_axis), 1e-12) for b in bodies
        ])),
        jnt_pos=f64(np.stack([b.jnt_pos for b in bodies])),
        dof_armature=f64(dof_armature),
        dof_damping=f64(dof_damping),
        dof_frictionloss=f64(dof_frictionloss),
        dof_limited=f64(dof_limited),
        dof_range=f64(dof_range),
        ancestor_mask=f64(ancestor_mask),
        actuator_dof=np.asarray(act_dof, dtype=np.int32),
        actuator_qposadr=np.asarray(act_qposadr, dtype=np.int32),
        actuator_kp=f64(act_kp),
        actuator_kv=f64(act_kv),
        actuator_ctrlrange=f64(np.stack(act_cr) if act_cr else np.zeros((0, 2))),
        actuator_forcerange=f64(np.stack(act_fr) if act_fr else np.zeros((0, 2))),
        geom_body=np.asarray([g["body"] for g in geom_meta], dtype=np.int32),
        geom_pos=f64(np.stack([g["pos"] for g in geom_meta])
                     if ng else np.zeros((0, 3))),
        geom_radius=f64([g["radius"] for g in geom_meta]),
        geom_stiffness=f64([
            g.get("stiffness") or contact_stiffness for g in geom_meta
        ]),
        geom_imp_dmin=(f64([g.get("imp_dmin") if g.get("imp_dmin")
                            is not None else 1.0 for g in geom_meta])
                       if has_imp_dmin else None),
        geom_imp_width=(f64([g.get("imp_width") if g.get("imp_width")
                             is not None else 1.0 for g in geom_meta])
                        if has_imp_width else None),
        geom_damping=f64([
            g.get("damping") or contact_damping for g in geom_meta
        ]),
        geom_friction=f64(np.stack([g["friction"] for g in geom_meta])
                          if ng else np.zeros((0, 3))),
        wbox_pos=f64(np.stack([w[0] for w in world_boxes])
                     if world_boxes else np.zeros((0, 3))),
        wbox_size=f64(np.stack([w[1] for w in world_boxes])
                      if world_boxes else np.zeros((0, 3))),
        site_pos=f64(np.stack([s[2] for s in sites]) if sites else np.zeros((0, 3))),
        key_qpos=f64(np.stack(key_qpos) if key_qpos else np.zeros((0, nq))),
        key_ctrl=f64(np.stack(key_ctrl) if key_ctrl else np.zeros((0, nu))),
        gravity=f64(gravity),
        contact_stiffness=f64(contact_stiffness),
        contact_damping=f64(contact_damping),
        friction_smoothing=f64(friction_smoothing),
        limit_stiffness=f64(limit_stiffness),
        limit_damping=f64(limit_damping),
        hfield_size=f64(hfield_spec["size"] if hfield_spec
                        else np.array([5.0, 5.0, 0.3, 0.001])),
    )
    return model_from_arrays(static, arrays, resolve_device(device))


def _np_fk(bodies: List[_Body], body_qpos_adr: List[int], qpos: np.ndarray):
    """Numpy forward kinematics (parse-time only)."""
    nb = len(bodies)
    xpos = np.zeros((nb, 3))
    xquat = np.zeros((nb, 4))
    for i, b in enumerate(bodies):
        if b.parent < 0:
            pp, pq = np.zeros(3), np.array([1.0, 0, 0, 0])
        else:
            pp, pq = xpos[b.parent], xquat[b.parent]
        adr = body_qpos_adr[i]
        if b.jnt_type == JNT_FREE:
            xpos[i] = qpos[adr : adr + 3]
            xquat[i] = qpos[adr + 3 : adr + 7]
        else:
            Rp = np_quat_to_mat(pq)
            p = pp + Rp @ b.pos
            q = np_quat_mul(pq, b.quat)
            if b.jnt_type == JNT_HINGE:
                qj = _axis_angle_quat(b.jnt_axis, qpos[adr])
                Rb = np_quat_to_mat(q)
                anchor = p + Rb @ b.jnt_pos
                q = np_quat_mul(q, qj)
                p = anchor - np_quat_to_mat(q) @ b.jnt_pos
            xpos[i] = p
            xquat[i] = q
    return xpos, xquat
