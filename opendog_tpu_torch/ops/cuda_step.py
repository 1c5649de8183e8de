"""The fused physics substep on the card: wrapper of CUDA kernels K1-K4
and of the exact terrain plant.

Port of ``opendog_tpu/ops/pallas_step.py`` (``build_pallas_substep``, the
``pl.pallas_call`` at line 115) in each of its modes: flat ground (K1), a
per-lane payload (K2), a per-lane contact plane (K3), per-geom planes (K4),
and each plane mode with a payload.  The kernels (``csrc/substep_kernel.cu``)
run over a table of model constants built here, all six one warp per
rollout (``csrc/substep_warp.cuh``; ``KERNEL_DESIGNS``); the note at the top
of the ``.cu`` file gives their design, what bounds them and the workspace
size class that the launcher picks from the model's sphere count.

Layout as in the JAX package: ``qpos (nq, K)``, ``qvel (nv, K)``,
``ctrl (nu, K)``, ``plane (4, K)`` or ``(4 * ngeom, K)``, ``payload (1, K)``,
float32, contiguous.  A step bound to a CUDA device launches its kernel on
the current stream; a step bound to the CPU runs the plain PyTorch version
(:mod:`.scalar_core`).  There is no fallback from one to the other.

:class:`ExactPlant` is the exact plant on a terrain (``exact_plant`` in the
same ``.cu`` file, the warp design on the ground of ``dynamics.step``: the
bilinear heightfield and the model's static boxes looked up under every
sphere at every substep); its launches go to :data:`PLANT_LAUNCHES`.

:class:`TrackingCostKernel` is the MPPI rollouts' tracking cost
(``rollout_tracking_cost``, ``csrc/tracking_cost.cuh``): one launch a
control step adds every lane's discounted step cost of
``solvers.costs.tracking_cost`` into the running total; its launches go to
:data:`COST_LAUNCHES`.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import os
import re
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..physics import dynamics as dyn
from ..physics.model import JNT_FREE, JNT_HINGE, JNT_NONE, Model
from ..utils import profiling
from . import build, scalar_core

# The kernel of each mode (with_plane, with_payload), named as its entry
# point in csrc/substep_kernel.cu.
KERNEL_NAMES = {
    (False, False): "substep_flat",                     # K1
    (False, True): "substep_payload",                   # K2
    (True, False): "substep_plane",                     # K3
    ("per_geom", False): "substep_pergeom",             # K4
    (True, True): "substep_plane_payload",              # K2 + K3
    ("per_geom", True): "substep_pergeom_payload",      # K2 + K4
}
# The design of each kernel, as substep_kernel.cu instantiates it: "warp"
# (SC_WARP_KERNEL, one warp per rollout) for all six.
KERNEL_DESIGNS = {name: "warp" for name in KERNEL_NAMES.values()}
_PLANE_CODE = {False: 0, True: 1, "per_geom": 2}  # SC_PLANE_* of the header

# Launches of the kernels, keyed by kernel and shape
# ("substep_pergeom K=256 x2"): the wrapper adds one where it launches a
# kernel and nowhere else; a program counter (``utils.profiling.counter``),
# so a graph's replay counts as its eager call.  Read and reset by whoever
# needs to show that a run went through the kernels.
LAUNCHES: collections.Counter = profiling.counter()
# Launches of the exact plant (``exact_plant``, the plant layer's kernel),
# keyed "exact_plant K=1 x10" as LAUNCHES keys the substep kernels; a
# counter of its own, so that LAUNCHES holds the rollout kernels' alone.
EXACT_PLANT = "exact_plant"
PLANT_LAUNCHES: collections.Counter = profiling.counter()
# Launches of the rollouts' tracking cost, keyed "tracking_cost L=256": one
# a control step of a solve whose step cost is ``costs.tracking_cost``'s.
ROLLOUT_COST = "rollout_tracking_cost"
COST_LAUNCHES: collections.Counter = profiling.counter()


def kernel_name(with_plane=False, with_payload: bool = False) -> str:
    """The kernel of a mode; raises for an unknown plane mode."""
    if with_plane not in scalar_core.PLANE_MODES:
        raise ValueError(f"with_plane must be one of "
                         f"{scalar_core.PLANE_MODES}, got {with_plane!r}")
    return KERNEL_NAMES[(with_plane, bool(with_payload))]


def launch_key(K: int, n_substeps: int, with_plane=False,
               with_payload: bool = False) -> str:
    return f"{kernel_name(with_plane, with_payload)} K={K} x{n_substeps}"


# ---------------------------------------------------------------------------
# the tables, laid out as csrc/substep_core.cuh and csrc/tracking_cost.cuh
# declare them
# ---------------------------------------------------------------------------

# field list -> (header, structure)
_TABLES = {"SUBSTEP_MODEL_FIELDS": ("substep_core.cuh", "SubstepModel"),
           "SUBSTEP_GROUND_FIELDS": ("substep_core.cuh", "SubstepGround"),
           "TRACKING_COST_FIELDS": ("tracking_cost.cuh", "TrackingCost")}


@functools.lru_cache(maxsize=None)
def table_layout(fields_macro: str = "SUBSTEP_MODEL_FIELDS"
                 ) -> Tuple[Dict[str, int], type]:
    """The compile-time constants and the ctypes mirror of ``SubstepModel``
    (or, with ``"SUBSTEP_GROUND_FIELDS"``, of ``SubstepGround``; with
    ``"TRACKING_COST_FIELDS"``, of ``TrackingCost``), read from the field
    list of its header (the one statement of the layout)."""
    header, struct = _TABLES[fields_macro]
    src = ""
    for path in dict.fromkeys(("substep_core.cuh", header)):
        with open(os.path.join(build.CSRC, path)) as f:
            src += f.read() + "\n"
    consts: Dict[str, int] = {}
    for name, expr in re.findall(r"^#define ((?:SC|TC)_\w+) ([^\n/]+)",
                                 src, re.M):
        terms = [t.strip() for t in expr.split("*")]
        if all(t.isdigit() or t.startswith("0x") or t in consts for t in terms):
            consts[name] = int(np.prod([consts[t] if t in consts else int(t, 0)
                                        for t in terms]))
    body = src[src.index(f"#define {fields_macro}"):]
    body = body[:body.index("\n\n")]
    fields = []
    for kind, name, size in re.findall(
            r"\b(INTS|FLTS|INT|FLT)\((\w+)(?:,\s*([^)]+))?\)", body):
        ctype = ctypes.c_int32 if kind.startswith("INT") else ctypes.c_float
        if size:
            n = int(np.prod([consts[t.strip()] if t.strip() in consts
                             else int(t) for t in size.split("*")]))
            ctype = ctype * n
        fields.append((name, ctype))
    return consts, type(struct, (ctypes.Structure,), {"_fields_": fields})


def substep_table(model: Model, dt: float) -> ctypes.Structure:
    """The kernel's table of ``model`` at timestep ``dt``.  Raises for a
    model the kernel does not take: no free base with equal serial chains,
    a joint other than hinges below the base, or a size above the
    compile-time maximums of ``substep_core.cuh``."""
    c, SubstepModel = table_layout()
    structure = dyn._arrow_structure(model)
    if structure is None:
        raise ValueError("the substep kernel needs a free base with equal "
                         "serial leg chains (block-arrow structure)")
    _, chains = structure
    nb, nv, nq, nu, ng = model.nbody, model.nv, model.nq, model.nu, model.ngeom
    G, n = chains.shape
    limits = dict(nbody=(nb, "SC_NB_MAX"), nv=(nv, "SC_NV_MAX"),
                  nq=(nq, "SC_NQ_MAX"), nu=(nu, "SC_NU_MAX"),
                  ngeom=(ng, "SC_NG_MAX"), chains=(G, "SC_G_MAX"),
                  chain_len=(n, "SC_NCH_MAX"))
    for what, (val, cap) in limits.items():
        if val > c[cap]:
            raise ValueError(f"model {what}={val} exceeds {cap}={c[cap]} of "
                             "csrc/substep_core.cuh")
    if model.body_parent[0] != -1 or model.jnt_type[0] != JNT_FREE:
        raise ValueError("body 0 must be the free base")
    for b in range(1, nb):
        if model.jnt_type[b] not in (JNT_HINGE, JNT_NONE):
            raise ValueError(f"body {b}: only hinge or welded bodies may "
                             "hang below the base")
        if not 0 <= model.body_parent[b] < b:
            raise ValueError(f"body {b}: parent must precede it")

    f32 = lambda name: model.numpy(name).astype(np.float32)
    anc = model.numpy("ancestor_mask")
    t = SubstepModel()

    def put(name, values):
        values = list(np.asarray(values).reshape(-1))
        getattr(t, name)[:len(values)] = values

    t.magic, t.nb, t.nv, t.nq, t.nu, t.ng = c["SC_MAGIC"], nb, nv, nq, nu, ng
    t.n_chains, t.chain_len = G, n
    t.dt = float(dt)
    t.gz = float(f32("gravity")[2])
    t.fric_eps = float(f32("friction_smoothing"))
    t.lim_k = float(f32("limit_stiffness"))
    t.lim_d = float(f32("limit_damping"))
    put("body_parent", [int(p) for p in model.body_parent])
    put("body_hinge", [int(j == JNT_HINGE) for j in model.jnt_type])
    put("body_qadr", [int(a) for a in model.body_qpos_adr])
    quats = model.numpy("body_quat").astype(np.float64)
    put("body_quat_ident", [int(np.allclose(q, [1, 0, 0, 0])) for q in quats])
    for name in ("body_pos", "body_quat", "body_mass", "body_com",
                 "body_inertia", "jnt_axis", "jnt_pos"):
        put(name, f32(name))
    body_dofs = [[j for j in range(nv) if anc[b, j] > 0] for b in range(nb)]
    put("body_ndof", [len(d) for d in body_dofs])
    flat = np.zeros((c["SC_NB_MAX"], c["SC_NV_MAX"]), np.int32)
    for b, dofs in enumerate(body_dofs):
        flat[b, :len(dofs)] = dofs
    put("body_dofs", flat)
    put("dof_body", [int(b) for b in model.dof_body])
    hinge_body = [-1] * nv
    for b in range(nb):
        if model.jnt_type[b] == JNT_HINGE:
            hinge_body[model.body_dof_adr[b]] = b
    if any(hb < 0 for hb in hinge_body[6:]):
        raise ValueError("every dof below the base must be a hinge")
    put("dof_hinge_body", hinge_body)
    put("dof_limited", [int(v > 0) for v in f32("dof_limited")])
    for name in ("dof_armature", "dof_damping", "dof_frictionloss",
                 "dof_range"):
        put(name, f32(name))
    put("act_dof", model.numpy("actuator_dof"))
    put("act_qadr", model.numpy("actuator_qposadr"))
    put("act_kp", f32("actuator_kp"))
    put("act_kv", f32("actuator_kv"))
    fr = f32("actuator_forcerange")
    put("act_lo", fr[:, 0])
    put("act_hi", fr[:, 1])
    put("geom_body", [int(b) for b in model.geom_body_static])
    put("geom_pos", f32("geom_pos"))
    put("geom_radius", f32("geom_radius"))
    put("geom_mu", f32("geom_friction")[:, 0])
    put("geom_k", f32("geom_stiffness"))
    put("geom_d", f32("geom_damping"))
    ch = np.zeros((c["SC_G_MAX"], c["SC_NCH_MAX"]), np.int32)
    ch[:G, :n] = chains
    put("chains", ch)
    pairs = scalar_core.arrow_pairs(model)
    pair_index = np.full((c["SC_NV_MAX"], c["SC_NV_MAX"]), -1, np.int32)
    for p, (i, j) in enumerate(pairs):
        pair_index[i, j] = pair_index[j, i] = p
    put("pair_index", pair_index)
    _put_warp_lists(t, put, model, c, body_dofs, pairs)
    return t


def ground_table(model: Model, nrow: int, ncol: int) -> ctypes.Structure:
    """The exact plant's ground table (``SubstepGround`` of
    ``csrc/substep_core.cuh``) for a (nrow, ncol) heightfield over the
    model's ``hfield_size`` and the model's static boxes: the constants of
    ``scalar_core.ground_constants``.  Raises for more boxes than
    ``SC_NBOX_MAX``."""
    c, SubstepGround = table_layout("SUBSTEP_GROUND_FIELDS")
    gc = scalar_core.ground_constants(model, nrow, ncol)
    nbox = len(gc["box_pos"])
    if nbox > c["SC_NBOX_MAX"]:
        raise ValueError(f"model has {nbox} static boxes; SC_NBOX_MAX="
                         f"{c['SC_NBOX_MAX']} of csrc/substep_core.cuh")
    t = SubstepGround()
    t.magic, t.nrow, t.ncol, t.nbox = c["SC_GROUND_MAGIC"], nrow, ncol, nbox
    for name in ("sx", "sy", "two_sx", "two_sy", "col_last", "row_last",
                 "x_max", "y_max", "cell_x", "cell_y"):
        setattr(t, name, float(gc[name]))
    for name in ("box_pos", "box_size"):
        values = [float(v) for v in gc[name].reshape(-1)]
        getattr(t, name)[:len(values)] = values
    return t


def _put_warp_lists(t, put, model: Model, c, body_dofs, pairs) -> None:
    """The index lists of the warp design (``csrc/substep_warp.cuh``): body
    chains, pair (i, j), each dof's position in the ancestor-dof lists and
    each dof's spheres.  Raises for a body tree that is not a base with
    serial chains below it, or where a pair's spheres are not its larger
    dof's."""
    nb, nv, ng = model.nbody, model.nv, model.ngeom
    t.npair = len(pairs)
    put("pair_i", [min(i, j) for i, j in pairs])
    put("pair_j", [max(i, j) for i, j in pairs])
    children = [[b for b in range(1, nb) if model.body_parent[b] == p]
                for p in range(nb)]
    chains = []
    for head in children[0]:
        chain = [head]
        while children[chain[-1]]:
            if len(children[chain[-1]]) > 1:
                raise ValueError(
                    f"body {chain[-1]} has {len(children[chain[-1]])} "
                    "children: the substep kernel needs serial chains of "
                    "bodies below the base")
            chain.append(children[chain[-1]][0])
        chains.append(chain)
    if len(chains) > c["SC_BCH_MAX"]:
        raise ValueError(f"model has {len(chains)} body chains below the "
                         f"base; SC_BCH_MAX={c['SC_BCH_MAX']}")
    if max(map(len, chains), default=0) > c["SC_BCHLEN_MAX"]:
        raise ValueError(f"a body chain exceeds SC_BCHLEN_MAX="
                         f"{c['SC_BCHLEN_MAX']}")
    t.n_bchains = len(chains)
    put("bchain_len", [len(ch) for ch in chains])
    flat = np.zeros((c["SC_BCH_MAX"], c["SC_BCHLEN_MAX"]), np.int32)
    for k, ch in enumerate(chains):
        flat[k, :len(ch)] = ch
    put("bchain_body", flat)
    dof_pos = [-1] * nv
    for b, dofs in enumerate(body_dofs):
        if len(dofs) > c["SC_ANC_MAX"]:
            raise ValueError(f"body {b} has {len(dofs)} ancestor dofs; "
                             f"SC_ANC_MAX={c['SC_ANC_MAX']}")
        for d, j in enumerate(dofs):
            if dof_pos[j] not in (-1, d):
                raise ValueError(f"dof {j} sits at different positions in "
                                 "the ancestor-dof lists of its bodies")
            dof_pos[j] = d
    put("dof_pos", dof_pos)
    anc = model.numpy("ancestor_mask")
    geom_body = [int(b) for b in model.geom_body_static]
    spheres = [[g for g in range(ng) if anc[geom_body[g], j] > 0]
               for j in range(nv)]
    for i, j in pairs:
        i, j = min(i, j), max(i, j)
        touch = [g for g in range(ng)
                 if anc[geom_body[g], i] > 0 and anc[geom_body[g], j] > 0]
        if touch != spheres[j]:
            raise ValueError(f"pair ({i}, {j}) touches other spheres than "
                             f"dof {j}")
    put("dof_nsph", [len(s) for s in spheres])
    put("dof_sph_off", np.cumsum([0] + [len(s) for s in spheres])[:-1])
    put("dof_sph", [g for s in spheres for g in s])


# ---------------------------------------------------------------------------
# the CUDA library
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def cuda_library() -> Tuple[ctypes.CDLL, "build.BuiltLibrary"]:
    """Build (once, at first use) and load ``csrc/substep_kernel.cu``."""
    built = build.build_library("substep_cuda", "substep_kernel.cu",
                                build.find_nvcc(), build.NVCC_FLAGS)
    lib = load_library(built.path)
    if lib.substep_model_size() != ctypes.sizeof(table_layout()[1]):
        raise RuntimeError("SubstepModel layout differs between the CUDA "
                           "library and its Python mirror")
    if lib.exact_plant_ground_size() != ctypes.sizeof(
            table_layout("SUBSTEP_GROUND_FIELDS")[1]):
        raise RuntimeError("SubstepGround layout differs between the CUDA "
                           "library and its Python mirror")
    if lib.tracking_cost_size() != ctypes.sizeof(
            table_layout("TRACKING_COST_FIELDS")[1]):
        raise RuntimeError("TrackingCost layout differs between the CUDA "
                           "library and its Python mirror")
    return lib, built


def load_library(path: str) -> ctypes.CDLL:
    """Load a build of ``csrc/substep_kernel.cu`` and declare its C
    interface."""
    lib = ctypes.CDLL(path)
    lib.substep_model_size.argtypes = []
    lib.substep_model_size.restype = ctypes.c_int
    # (plane mode, with_payload, ngeom) -> the launch shape of the kernel
    # that substep_launch picks for them
    for fn in (lib.substep_warps_per_block, lib.substep_warp_smem_bytes,
               lib.substep_warp_occupancy):
        fn.argtypes = [ctypes.c_int] * 3
        fn.restype = ctypes.c_int
    lib.substep_entry.argtypes = [ctypes.c_int] * 3
    lib.substep_entry.restype = ctypes.c_char_p
    lib.substep_launch.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.substep_launch.restype = ctypes.c_int
    for fn in (lib.exact_plant_ground_size, lib.exact_plant_warps_per_block,
               lib.exact_plant_smem_bytes, lib.exact_plant_occupancy):
        fn.argtypes = []
        fn.restype = ctypes.c_int
    lib.exact_plant_launch.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.exact_plant_launch.restype = ctypes.c_int
    lib.tracking_cost_size.argtypes = []
    lib.tracking_cost_size.restype = ctypes.c_int
    lib.tracking_cost_launch.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.tracking_cost_launch.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


def build_plain_substep(model: Model, dt: float, n_substeps: int = 1,
                        with_plane=False,
                        with_payload: bool = False) -> Callable:
    """The plain PyTorch version of the kernels, on tensors of any device:
    ``step(qpos (nq,K), qvel (nv,K), ctrl (nu,K), plane=None, payload=None)
    -> (qpos', qvel')``; with ``with_plane="terrain"`` (the exact plant's)
    ``plane`` is the (nrow, ncol) heights."""
    sub = scalar_core.build_substep(model, dt, with_plane, with_payload)
    terrain = with_plane == scalar_core.TERRAIN

    def step(qpos, qvel, ctrl, plane=None, payload=None):
        qp, qv, ct = qpos.unbind(0), qvel.unbind(0), ctrl.unbind(0)
        pl = (plane if terrain else
              plane.unbind(0) if plane is not None else None)
        py = payload[0] if payload is not None else None
        for _ in range(n_substeps):
            qp, qv = sub(qp, qv, ct, pl, py)
        return torch.stack(qp), torch.stack(qv)

    return step


def _check_rows(device, arrays) -> int:
    """K of the (rows, K) inputs ``arrays`` ((name, tensor, rows), qpos
    first); raises unless each is float32, contiguous and on ``device``."""
    qpos = arrays[0][1]
    K = qpos.shape[-1] if qpos.dim() == 2 else -1
    for name, x, rows in arrays:
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, the step on {device}")
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {x.dtype}")
        if x.dim() != 2 or x.shape != (rows, K) or K < 1:
            raise ValueError(f"{name} must have shape ({rows}, K), got "
                             f"{tuple(x.shape)} (K from qpos: {K})")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return K


class CudaSubstep:
    """``step(qpos (nq,K), qvel (nv,K), ctrl (nu,K), plane=None,
    payload=None) -> (qpos', qvel')`` running ``n_substeps`` substeps of
    timestep ``dt`` per call in one mode, on the device it was built for.
    ``plane`` is ``(4, K)`` with ``with_plane=True``, ``(4 * ngeom, K)``
    with ``with_plane="per_geom"``, and must be None otherwise; ``payload``
    is ``(1, K)`` with ``with_payload=True`` and None otherwise."""

    def __init__(self, model: Model, dt: float, n_substeps: int, device,
                 with_plane=False, with_payload: bool = False):
        if n_substeps < 1:
            raise ValueError("n_substeps must be >= 1")
        self.name = kernel_name(with_plane, with_payload)
        self.with_plane, self.with_payload = with_plane, bool(with_payload)
        self.device = resolve_device(device)
        self.dt, self.n_substeps = float(dt), int(n_substeps)
        self.nq, self.nv, self.nu = model.nq, model.nv, model.nu
        self.ngeom = model.ngeom
        self.plane_rows = scalar_core.plane_rows(model, with_plane)
        table = substep_table(model, dt)
        # the entry point a launch runs: the mode's kernel, or the size
        # class the launcher picks for this model (LAUNCHES keys by mode)
        self.entry = self.name
        if self.device.type == "cuda":
            self._lib, _ = cuda_library()
            self.entry = self._lib.substep_entry(
                _PLANE_CODE[with_plane], int(self.with_payload),
                self.ngeom).decode()
            raw = bytearray(memoryview(table).cast("B"))
            self._table = torch.frombuffer(raw, dtype=torch.uint8).to(
                self.device)
            self._plain = None
        elif self.device.type == "cpu":
            self._plain = build_plain_substep(model, dt, n_substeps,
                                              with_plane, with_payload)
        else:
            raise ValueError(f"unsupported device {self.device}")

    def _check(self, qpos, qvel, ctrl, plane, payload) -> int:
        arrays = [("qpos", qpos, self.nq), ("qvel", qvel, self.nv),
                  ("ctrl", ctrl, self.nu)]
        for name, x, rows, wanted in (("plane", plane, self.plane_rows,
                                       bool(self.with_plane)),
                                      ("payload", payload, 1,
                                       self.with_payload)):
            if wanted and x is None:
                raise ValueError(f"{self.name} needs a {name} of shape "
                                 f"({rows}, K)")
            if not wanted and x is not None:
                raise ValueError(f"{self.name} takes no {name}: build the "
                                 "step with its mode to pass one")
            if wanted:
                arrays.append((name, x, rows))
        return _check_rows(self.device, arrays)

    def __call__(self, qpos, qvel, ctrl, plane=None, payload=None):
        K = self._check(qpos, qvel, ctrl, plane, payload)
        if self._plain is not None:
            return self._plain(qpos, qvel, ctrl, plane, payload)
        qpos_out = torch.empty_like(qpos)
        qvel_out = torch.empty_like(qvel)
        stream = torch.cuda.current_stream(self.device).cuda_stream
        ptr = lambda x: None if x is None else x.data_ptr()
        rc = self._lib.substep_launch(
            self._table.data_ptr(), qpos.data_ptr(), qvel.data_ptr(),
            ctrl.data_ptr(), ptr(plane), ptr(payload), qpos_out.data_ptr(),
            qvel_out.data_ptr(), K, self.n_substeps,
            _PLANE_CODE[self.with_plane], int(self.with_payload),
            self.ngeom, stream)
        if rc != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA "
                               f"error {rc}")
        LAUNCHES[launch_key(K, self.n_substeps, self.with_plane,
                            self.with_payload)] += 1
        return qpos_out, qvel_out


def plant_launch_key(K: int, n_substeps: int) -> str:
    return f"{EXACT_PLANT} K={K} x{n_substeps}"


class ExactPlant:
    """``step(qpos (nq,K), qvel (nv,K), ctrl (nu,K)) -> (qpos', qvel')``
    running ``n_substeps`` substeps of timestep ``dt`` per call on the
    ground of ``physics.dynamics.step`` on a terrain: the bilinear
    heightfield ``heights`` (one (nrow, ncol) grid over the model's
    ``hfield_size``, under every rollout) and the model's static boxes,
    looked up under every sphere at every substep.  On CUDA one launch of
    ``exact_plant`` a call, counted in :data:`PLANT_LAUNCHES`; on the CPU
    the plain version (``scalar_core``'s terrain ground).  The step keeps
    ``heights`` (a CUDA graph that replays it reads that memory).  Raises
    for a model the kernel does not take: as :func:`substep_table`, more
    static boxes than ``SC_NBOX_MAX``, or the progressive contact
    impedance (``geom_imp_dmin``), which only the op-graph step
    computes."""

    def __init__(self, model: Model, dt: float, n_substeps: int,
                 heights: torch.Tensor, device=None):
        if n_substeps < 1:
            raise ValueError("n_substeps must be >= 1")
        if model.geom_imp_dmin is not None:
            raise ValueError("the exact plant kernel has no progressive "
                             "contact impedance (geom_imp_dmin): the "
                             "op-graph step computes that contact")
        self.device = resolve_device(device)
        if heights.dim() != 2:
            raise ValueError(f"heights must be one (nrow, ncol) grid, got "
                             f"shape {tuple(heights.shape)}")
        if heights.device != self.device or heights.dtype != torch.float32:
            raise ValueError(f"heights must be float32 on {self.device}, "
                             f"got {heights.dtype} on {heights.device}")
        self.heights = heights.contiguous()
        self.dt, self.n_substeps = float(dt), int(n_substeps)
        self.nq, self.nv, self.nu = model.nq, model.nv, model.nu
        table = substep_table(model, dt)
        ground = ground_table(model, *self.heights.shape)
        if self.device.type == "cuda":
            self._lib, _ = cuda_library()
            as_bytes = lambda t: torch.frombuffer(
                bytearray(memoryview(t).cast("B")), dtype=torch.uint8).to(
                    self.device)
            self._table, self._ground = as_bytes(table), as_bytes(ground)
            self._plain = None
        elif self.device.type == "cpu":
            self._plain = build_plain_substep(model, dt, n_substeps,
                                              scalar_core.TERRAIN)
        else:
            raise ValueError(f"unsupported device {self.device}")

    def __call__(self, qpos, qvel, ctrl):
        K = _check_rows(self.device, (("qpos", qpos, self.nq),
                                      ("qvel", qvel, self.nv),
                                      ("ctrl", ctrl, self.nu)))
        if self._plain is not None:
            return self._plain(qpos, qvel, ctrl, self.heights)
        qpos_out = torch.empty_like(qpos)
        qvel_out = torch.empty_like(qvel)
        stream = torch.cuda.current_stream(self.device).cuda_stream
        rc = self._lib.exact_plant_launch(
            self._table.data_ptr(), self._ground.data_ptr(),
            self.heights.data_ptr(), qpos.data_ptr(), qvel.data_ptr(),
            ctrl.data_ptr(), qpos_out.data_ptr(), qvel_out.data_ptr(), K,
            self.n_substeps, stream)
        if rc != 0:
            raise RuntimeError(f"{EXACT_PLANT} kernel launch failed: CUDA "
                               f"error {rc}")
        PLANT_LAUNCHES[plant_launch_key(K, self.n_substeps)] += 1
        return qpos_out, qvel_out


def tracking_cost_table(model: Model, params,
                        home_joint_qpos) -> ctypes.Structure:
    """The table of ``csrc/tracking_cost.cuh`` (``TrackingCost``) for
    ``solvers.costs.tracking_cost(model, params, home_joint_qpos)``: the
    weights and targets of ``params`` (a ``TrackingCostParams``) and the
    home joints, as float32.  Raises where the home joints are not the
    model's nq - 7 or a size exceeds ``substep_core.cuh``'s maximums."""
    c, TrackingCost = table_layout("TRACKING_COST_FIELDS")
    home = torch.as_tensor(home_joint_qpos).detach().reshape(-1).cpu()
    if home.numel() != model.nq - 7:
        raise ValueError(f"home_joint_qpos has {home.numel()} entries; the "
                         f"model has nq - 7 = {model.nq - 7} joints")
    if model.nq > c["SC_NQ_MAX"] or model.nu > c["SC_NU_MAX"]:
        raise ValueError(f"model nq={model.nq}, nu={model.nu} exceeds "
                         "SC_NQ_MAX / SC_NU_MAX of csrc/substep_core.cuh")
    t = TrackingCost()
    t.magic, t.nq, t.nv, t.nu = c["TC_MAGIC"], model.nq, model.nv, model.nu
    for name in ("w_vel", "w_yaw_rate", "w_height", "w_upright",
                 "w_joint_posture", "w_ctrl_rate", "w_lateral",
                 "desired_yaw_rate", "target_height"):
        setattr(t, name, getattr(params, name))  # rounded to float32
    t.desired_vel[:2] = params.desired_vel_xy
    t.home_j[:home.numel()] = home.to(torch.float32).tolist()
    return t


def cost_launch_key(L: int) -> str:
    return f"tracking_cost L={L}"


class TrackingCostKernel:
    """``cost(qpos (nq,L), qvel (nv,L), ctrl (nu,L), prev (nu,L), disc,
    total=None) -> total (L,)``: one launch of ``rollout_tracking_cost``
    that computes the step cost of ``costs.tracking_cost(model, params,
    home_joint_qpos)`` in every lane from the substep kernels' row layout,
    times ``disc``, into a new total (``total`` None) or added to
    ``total`` in place, which it returns.  As the op path computes
    ``cost(state, ctrl, prev) * disc`` and ``total + c`` (on the card, in
    the order of PyTorch's reductions there).  CUDA only: on the CPU the
    rollouts call the cost's closure.  Launches go to
    :data:`COST_LAUNCHES`."""

    def __init__(self, model: Model, params, home_joint_qpos, device):
        self.device = resolve_device(device)
        if self.device.type != "cuda":
            raise ValueError(f"{ROLLOUT_COST} runs on a CUDA device, not "
                             f"{self.device}")
        self.nq, self.nv, self.nu = model.nq, model.nv, model.nu
        self._table = tracking_cost_table(model, params, home_joint_qpos)
        self._lib, _ = cuda_library()

    def __call__(self, qpos, qvel, ctrl, prev, disc: float, total=None):
        L = _check_rows(self.device, (("qpos", qpos, self.nq),
                                      ("qvel", qvel, self.nv),
                                      ("ctrl", ctrl, self.nu),
                                      ("prev", prev, self.nu)))
        accumulate = total is not None
        if total is None:
            total = torch.empty(L, dtype=torch.float32, device=self.device)
        elif total.shape != (L,) or not total.is_contiguous():
            raise ValueError(f"total must be a contiguous ({L},) tensor")
        stream = torch.cuda.current_stream(self.device).cuda_stream
        rc = self._lib.tracking_cost_launch(
            ctypes.byref(self._table), qpos.data_ptr(), qvel.data_ptr(),
            ctrl.data_ptr(), prev.data_ptr(), total.data_ptr(), L,
            float(disc), int(accumulate), stream)
        if rc != 0:
            raise RuntimeError(f"{ROLLOUT_COST} kernel launch failed: CUDA "
                               f"error {rc}")
        COST_LAUNCHES[cost_launch_key(L)] += 1
        return total


def build_cuda_substep(model: Model, dt: float, n_substeps: int = 1,
                       device=None, with_plane=False,
                       with_payload: bool = False) -> CudaSubstep:
    """Build the substep step of ``model`` at timestep ``dt`` on ``device``
    (CUDA unless the caller names another), in the mode given by
    ``with_plane`` (False, True or "per_geom") and ``with_payload``, as
    ``build_pallas_substep`` takes them.  On CUDA this builds the kernel
    library from ``csrc/`` at first use; ``nvcc`` must exist."""
    return CudaSubstep(model, dt, n_substeps, device, with_plane,
                       with_payload)


def rows_from_batch(arr: torch.Tensor) -> torch.Tensor:
    """(K, n) batch-first -> (n, K) row layout, contiguous."""
    return arr.transpose(0, 1).contiguous()


def batch_from_rows(arr: torch.Tensor) -> torch.Tensor:
    """(n, K) row layout -> (K, n) batch-first, contiguous."""
    return arr.transpose(0, 1).contiguous()
