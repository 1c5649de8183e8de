"""The fused physics substep on the card: wrapper of CUDA kernel K1.

Port of ``opendog_tpu/ops/pallas_step.py`` (``build_pallas_substep``, the
``pl.pallas_call`` at line 115) in its flat-ground mode.  The kernel
(``csrc/substep_kernel.cu`` around ``csrc/substep_core.cuh``) runs one
thread per rollout over a table of model constants built here; see the note
at the top of the ``.cu`` file for its design and what bounds it.

Layout as in the JAX package: ``qpos (nq, K)``, ``qvel (nv, K)``,
``ctrl (nu, K)``, float32, contiguous.  A step bound to a CUDA device
launches the kernel on the current stream; a step bound to the CPU runs the
plain PyTorch version (:mod:`.scalar_core`).  There is no fallback from one
to the other.
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
from . import build, scalar_core

KERNEL_NAME = "substep_flat"

# Launches of the kernel, keyed by shape ("substep_flat K=256 x2"): the
# wrapper adds one where it launches the kernel and nowhere else.  Read and
# reset by whoever needs to show that a run went through the kernel.
LAUNCHES: collections.Counter = collections.Counter()


def launch_key(K: int, n_substeps: int) -> str:
    return f"{KERNEL_NAME} K={K} x{n_substeps}"


# ---------------------------------------------------------------------------
# the model table, laid out as csrc/substep_core.cuh declares it
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def table_layout() -> Tuple[Dict[str, int], type]:
    """The compile-time constants and the ctypes mirror of ``SubstepModel``,
    read from the field list of ``csrc/substep_core.cuh`` (the one statement
    of the layout)."""
    with open(os.path.join(build.CSRC, "substep_core.cuh")) as f:
        src = f.read()
    consts: Dict[str, int] = {}
    for name, expr in re.findall(r"^#define (SC_\w+) ([^\n/]+)", src, re.M):
        terms = [t.strip() for t in expr.split("*")]
        if all(t.isdigit() or t.startswith("0x") or t in consts for t in terms):
            consts[name] = int(np.prod([consts[t] if t in consts else int(t, 0)
                                        for t in terms]))
    body = src[src.index("#define SUBSTEP_MODEL_FIELDS"):]
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

    class SubstepModel(ctypes.Structure):
        _fields_ = fields

    return consts, SubstepModel


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
    pair_index = np.full((c["SC_NV_MAX"], c["SC_NV_MAX"]), -1, np.int32)
    for p, (i, j) in enumerate(scalar_core.arrow_pairs(model)):
        pair_index[i, j] = pair_index[j, i] = p
    put("pair_index", pair_index)
    return t


# ---------------------------------------------------------------------------
# the CUDA library
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def cuda_library() -> Tuple[ctypes.CDLL, "build.BuiltLibrary"]:
    """Build (once, at first use) and load ``csrc/substep_kernel.cu``."""
    built = build.build_library("substep_cuda", "substep_kernel.cu",
                                build.find_nvcc(), build.NVCC_FLAGS)
    lib = ctypes.CDLL(built.path)
    lib.substep_model_size.argtypes = []
    lib.substep_model_size.restype = ctypes.c_int
    lib.substep_launch.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.substep_launch.restype = ctypes.c_int
    if lib.substep_model_size() != ctypes.sizeof(table_layout()[1]):
        raise RuntimeError("SubstepModel layout differs between the CUDA "
                           "library and its Python mirror")
    return lib, built


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


def build_plain_substep(model: Model, dt: float,
                        n_substeps: int = 1) -> Callable:
    """The plain PyTorch version of the kernel, on tensors of any device:
    ``step(qpos (nq,K), qvel (nv,K), ctrl (nu,K)) -> (qpos', qvel')``."""
    sub = scalar_core.build_substep(model, dt)

    def step(qpos, qvel, ctrl):
        qp, qv, ct = qpos.unbind(0), qvel.unbind(0), ctrl.unbind(0)
        for _ in range(n_substeps):
            qp, qv = sub(qp, qv, ct)
        return torch.stack(qp), torch.stack(qv)

    return step


class CudaSubstep:
    """``step(qpos (nq,K), qvel (nv,K), ctrl (nu,K)) -> (qpos', qvel')``
    running ``n_substeps`` flat-ground substeps of timestep ``dt`` per
    call, on the device it was built for."""

    def __init__(self, model: Model, dt: float, n_substeps: int, device):
        if n_substeps < 1:
            raise ValueError("n_substeps must be >= 1")
        self.device = resolve_device(device)
        self.dt, self.n_substeps = float(dt), int(n_substeps)
        self.nq, self.nv, self.nu = model.nq, model.nv, model.nu
        table = substep_table(model, dt)
        if self.device.type == "cuda":
            self._lib, _ = cuda_library()
            raw = bytearray(memoryview(table).cast("B"))
            self._table = torch.frombuffer(raw, dtype=torch.uint8).to(
                self.device)
            self._plain = None
        elif self.device.type == "cpu":
            self._plain = build_plain_substep(model, dt, n_substeps)
        else:
            raise ValueError(f"unsupported device {self.device}")

    def _check(self, qpos, qvel, ctrl) -> int:
        K = qpos.shape[-1] if qpos.dim() == 2 else -1
        for name, x, rows in (("qpos", qpos, self.nq), ("qvel", qvel, self.nv),
                              ("ctrl", ctrl, self.nu)):
            if x.device != self.device:
                raise ValueError(f"{name} is on {x.device}, the step on "
                                 f"{self.device}")
            if x.dtype != torch.float32:
                raise ValueError(f"{name} must be float32, got {x.dtype}")
            if x.dim() != 2 or x.shape != (rows, K) or K < 1:
                raise ValueError(f"{name} must have shape ({rows}, K), got "
                                 f"{tuple(x.shape)} (K from qpos: {K})")
            if not x.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        return K

    def __call__(self, qpos, qvel, ctrl):
        K = self._check(qpos, qvel, ctrl)
        if self._plain is not None:
            return self._plain(qpos, qvel, ctrl)
        qpos_out = torch.empty_like(qpos)
        qvel_out = torch.empty_like(qvel)
        stream = torch.cuda.current_stream(self.device).cuda_stream
        rc = self._lib.substep_launch(
            self._table.data_ptr(), qpos.data_ptr(), qvel.data_ptr(),
            ctrl.data_ptr(), qpos_out.data_ptr(), qvel_out.data_ptr(),
            K, self.n_substeps, stream)
        if rc != 0:
            raise RuntimeError(f"substep kernel launch failed: CUDA error {rc}")
        LAUNCHES[launch_key(K, self.n_substeps)] += 1
        return qpos_out, qvel_out


def build_cuda_substep(model: Model, dt: float, n_substeps: int = 1,
                       device=None) -> CudaSubstep:
    """Build the substep step of ``model`` at timestep ``dt`` on ``device``
    (CUDA unless the caller names another).  On CUDA this builds the kernel
    library from ``csrc/`` at first use; ``nvcc`` must exist."""
    return CudaSubstep(model, dt, n_substeps, device)


def rows_from_batch(arr: torch.Tensor) -> torch.Tensor:
    """(K, n) batch-first -> (n, K) row layout, contiguous."""
    return arr.transpose(0, 1).contiguous()


def batch_from_rows(arr: torch.Tensor) -> torch.Tensor:
    """(n, K) row layout -> (K, n) batch-first, contiguous."""
    return arr.transpose(0, 1).contiguous()
