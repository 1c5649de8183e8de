"""The warp design of the substep kernels (csrc/substep_warp.cuh, which runs
all six kernels on the card) on the CPU, through its g++ host build: each
phase runs as a loop over the 32 lanes, in order or in reverse, on a
workspace filled with NaN before every substep.

It must equal the serial oracle (sc_substep of csrc/substep_core.cuh, one
rollout straight through, in the same host library; no kernel runs it) bit
for bit, in both lane orders and in both workspace size classes: every
float is made by the same operations in the same order, only by another
lane, and no phase reads what another lane writes in the same phase.  Both
are held against the plain PyTorch version, and the model table's index
lists against the arrow pairs and the ancestor mask.  The kernels
themselves are compared with the plain version on the card by
tests/test_torch_gpu.py and chip_smoke.py.
"""
import ctypes
import os
import re
import shutil

import numpy as np
import pytest
import torch

from opendog_tpu_torch import assets
from opendog_tpu_torch.ops import build, cuda_step, scalar_core
from chip_smoke import random_batch, random_modes

torch.set_num_threads(1)

# host build against the plain version: a float32 reference of the same
# arithmetic (libm's sinf / cosf against PyTorch's), as in
# tests/test_torch_substep_modes.py
TIGHT = dict(qpos=1e-5, qvel=1e-4)
MODES = {  # name: (with_plane, with_payload)
    "flat": (False, False), "payload": (False, True),
    "plane": (True, False), "pergeom": ("per_geom", False),
    "plane_payload": (True, True), "pergeom_payload": ("per_geom", True),
}
# the modes whose kernels run the warp design: all six
CARD = tuple(MODES)
ROBOTS = {"go1": lambda: assets.load_go1("flat", device="cpu"),
          "opendog": lambda: assets.load_opendog("flat", device="cpu"),
          "mini": lambda: assets.load_mini(device="cpu")}
STEPS = [(0.01, 1), (0.01, 2), (0.002, 1), (0.002, 2)]  # (dt, n_substeps)
K = 8
# the workspace size classes (sphere capacity) of csrc/substep_warp.cuh
SC_NG_MAX = cuda_step.table_layout()[0]["SC_NG_MAX"]
with open(os.path.join(build.CSRC, "substep_warp.cuh")) as _f:
    SC_NG_SMALL = int(re.search(r"^#define SC_NG_SMALL (\d+)", _f.read(),
                                re.M).group(1))


@pytest.fixture(scope="module")
def host_lib():
    """g++ build of csrc/substep_host.cpp (a test aid: no entry point of
    the package reaches it)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    built = build.build_library("substep_host", "substep_host.cpp", "g++",
                                build.GXX_FLAGS)
    lib = ctypes.CDLL(built.path)
    lib.substep_host.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
    lib.substep_host.restype = ctypes.c_int
    lib.substep_host_warp.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
    lib.substep_host_warp.restype = ctypes.c_int
    return lib


def _inputs(m, mode, seed=1):
    """chip_smoke.py's random states with the feet on the ground, random
    planes near z = 0 and payloads U(0, 3) kg: (qpos, qvel, ctrl, plane,
    payload), torch (rows, K) or None."""
    with_plane, with_payload = MODES[mode]
    arrays = (random_batch(m, K, seed, on_ground=True)
              + random_modes(m, K, with_plane, with_payload, seed))
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _host(lib, m, dt, n, mode, args, design, ng_class=None):
    """One host call: design "thread" (the serial oracle), "warp" or
    "warp_reversed", the latter on a workspace of size class ``ng_class``
    (default SC_NG_MAX)."""
    table = cuda_step.substep_table(m, dt)
    qp, qv, ct, plane, payload = args
    out_p, out_v = torch.empty_like(qp), torch.empty_like(qv)
    ptr = lambda x: None if x is None else x.data_ptr()
    with_plane, with_payload = MODES[mode]
    call = (ctypes.addressof(table), qp.data_ptr(), qv.data_ptr(),
            ct.data_ptr(), ptr(plane), ptr(payload), out_p.data_ptr(),
            out_v.data_ptr(), K, n, cuda_step._PLANE_CODE[with_plane],
            int(with_payload))
    if design == "thread":
        rc = lib.substep_host(*call)
    else:
        rc = lib.substep_host_warp(*call, ng_class or SC_NG_MAX,
                                   int(design == "warp_reversed"))
    assert rc == 0
    return out_p.numpy(), out_v.numpy()


@pytest.mark.parametrize("design", ["warp", "warp_reversed"])
@pytest.mark.parametrize("dt,n", STEPS)
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("robot", sorted(ROBOTS))
def test_warp_design_equals_one_thread_design_bit_for_bit(host_lib, robot,
                                                          mode, dt, n,
                                                          design):
    """K=8 at 10 ms and 2 ms, one and two substeps, in every mode: every
    qpos and qvel of the warp design, in either lane order, equals the
    one-thread design's exactly, and is finite."""
    m = ROBOTS[robot]()
    args = _inputs(m, mode)
    want = _host(host_lib, m, dt, n, mode, args, "thread")
    got = _host(host_lib, m, dt, n, mode, args, design)
    assert np.isfinite(got[0]).all() and np.isfinite(got[1]).all()
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


@pytest.mark.parametrize("design", ["warp", "warp_reversed"])
@pytest.mark.parametrize("dt,n", STEPS)
@pytest.mark.parametrize("robot", ["mini", "opendog"])
def test_small_workspace_equals_one_thread_design_bit_for_bit(host_lib, robot,
                                                              dt, n, design):
    """The plane + payload mode on the small size class of the workspace
    (SC_NG_SMALL spheres, the batch kernel's for OpenDOG's 24 and mini's 7)
    equals the serial oracle bit for bit, as the full class does."""
    m = ROBOTS[robot]()
    assert m.ngeom <= SC_NG_SMALL < SC_NG_MAX
    args = _inputs(m, "plane_payload")
    want = _host(host_lib, m, dt, n, "plane_payload", args, "thread")
    got = _host(host_lib, m, dt, n, "plane_payload", args, design,
                SC_NG_SMALL)
    assert np.isfinite(got[0]).all() and np.isfinite(got[1]).all()
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_small_workspace_refuses_a_larger_model(host_lib):
    """Go1's 78 spheres do not fit the small class: the host build refuses
    it (the kernel launcher picks the full class for such a model)."""
    m = ROBOTS["go1"]()
    args = _inputs(m, "plane_payload")
    with pytest.raises(AssertionError):
        _host(host_lib, m, 0.01, 1, "plane_payload", args, "warp",
              SC_NG_SMALL)


@pytest.mark.parametrize("mode,robot,dt,n", [
    (mode, robot, dt, n) for mode in CARD for robot in sorted(ROBOTS)
    for dt, n in STEPS
    # mini at 10 ms (its own timestep is 2 ms): g++ and PyTorch read 1.2e-4
    # qvel apart after two substeps, in both designs alike
    if not (robot == "mini" and dt == 0.01)
    # mini on per-geom planes, two substeps: a rollout reaches 523 rad/s,
    # where g++ and PyTorch read two ulps (1.2e-4) apart, in both designs
    # alike
    and not (robot == "mini" and mode == "pergeom" and n == 2)])
def test_warp_design_matches_plain(host_lib, robot, mode, dt, n):
    """The warp design against the plain version on the same inputs.
    Tolerance: TIGHT plus four times what the plain version's own result
    moves, rollout by rollout, under a 1e-7 relative change of qvel, as in
    tests/test_torch_substep_modes.py: one ulp of libm's sinf / cosf
    against PyTorch's is magnified by contact states at 10 ms."""
    m = ROBOTS[robot]()
    args = _inputs(m, mode)
    plain = cuda_step.build_plain_substep(m, dt, n, *MODES[mode])
    want = plain(*args)
    nudged = plain(args[0], args[1] * (1 + 1e-7), *args[2:])
    got = _host(host_lib, m, dt, n, mode, args, "warp")
    for name, g, w, v in zip(("qpos", "qvel"), got, want, nudged):
        spread = (w - v).abs().max(dim=0).values.numpy()
        err = np.abs(g - w.numpy()).max(axis=0)
        assert (err <= TIGHT[name] + 4 * spread).all(), (name, err, spread)


def test_kernel_designs_match_the_instantiations():
    """cuda_step.KERNEL_DESIGNS is "warp" for all six entry points, and
    substep_kernel.cu declares each once with SC_WARP_KERNEL and nothing of
    the one-thread design (SC_KERNEL, launch_thread); the launcher picks
    only declared kernels, every entry point among them, and the batch's
    small-class kernel (SC_WARP_KERNEL_OF) for the plane + payload mode."""
    with open(os.path.join(build.CSRC, "substep_kernel.cu")) as f:
        src = f.read()
    declared = re.findall(r"^SC_WARP_KERNEL\((\w+),", src, re.M)
    assert sorted(declared) == sorted(set(declared)) == sorted(
        cuda_step.KERNEL_NAMES.values())
    assert set(cuda_step.KERNEL_DESIGNS.values()) == {"warp"}
    assert set(cuda_step.KERNEL_DESIGNS) == set(declared)
    assert not re.search(r"\bSC_KERNEL\b|\blaunch_thread\b|\bsc_substep<",
                         src)
    small = re.findall(r"^SC_WARP_KERNEL_OF\((\w+),\s*SC_PLANE_LANE,\s*"
                       r"true,\s*SC_NG_SMALL,", src, re.M)
    assert small == ["substep_plane_payload_small"]
    body = src[src.index("static WarpKernel pick_kernel("):]
    body = body[:body.index("\n}\n")]
    picked = re.findall(r"\bsubstep_\w+", body)
    assert sorted(set(picked)) == sorted(declared + small)


@pytest.mark.parametrize("robot", sorted(ROBOTS))
def test_table_index_lists(robot):
    """The warp design's lists in the model table: the body chains cover
    every body below the base once, each parent before its child; the pairs
    are scalar_core.arrow_pairs with i <= j; each dof's spheres are exactly
    the spheres whose body it moves (the ancestor mask), in increasing
    order, and each pair's spheres (those of its larger dof) exactly the
    spheres that both of its dofs move; each dof sits at dof_pos in the
    ancestor-dof list of every body it moves."""
    m = ROBOTS[robot]()
    t = cuda_step.substep_table(m, m.timestep)
    c, _ = cuda_step.table_layout()
    anc = m.numpy("ancestor_mask")
    parent = [int(p) for p in m.body_parent]
    geom_body = [int(b) for b in m.geom_body_static]
    chains = [list(t.bchain_body[k * c["SC_BCHLEN_MAX"]:
                                 k * c["SC_BCHLEN_MAX"] + t.bchain_len[k]])
              for k in range(t.n_bchains)]
    assert sorted(b for ch in chains for b in ch) == list(range(1, m.nbody))
    for ch in chains:
        assert parent[ch[0]] == 0
        assert all(parent[b] == a for a, b in zip(ch, ch[1:]))
    pairs = scalar_core.arrow_pairs(m)
    assert t.npair == len(pairs)
    assert list(zip(t.pair_i[:t.npair], t.pair_j[:t.npair])) == pairs
    spheres = {}
    for j in range(m.nv):
        start = t.dof_sph_off[j]
        spheres[j] = list(t.dof_sph[start:start + t.dof_nsph[j]])
        assert spheres[j] == [g for g in range(m.ngeom)
                              if anc[geom_body[g], j] > 0]
        for b in range(m.nbody):
            dofs = [d for d in range(m.nv) if anc[b, d] > 0]
            if j in dofs:
                assert dofs.index(j) == t.dof_pos[j]
    for i, j in pairs:
        assert spheres[j] == [g for g in range(m.ngeom)
                              if anc[geom_body[g], i] > 0
                              and anc[geom_body[g], j] > 0]


def test_table_refuses_a_branching_body_tree():
    """A body with two children below the base has no serial chain: the
    table raises, as for the other limits of the kernels."""
    m = ROBOTS["go1"]()
    parent = list(m.body_parent)
    parent[3] = 1  # body 1 then carries bodies 2 and 3
    with pytest.raises(ValueError, match="serial chains"):
        cuda_step.substep_table(m.replace(body_parent=tuple(parent)),
                                m.timestep)
