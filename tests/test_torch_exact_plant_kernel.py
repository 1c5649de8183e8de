"""The exact plant kernel's ground on the CPU: its plain version
(``scalar_core``'s ``"terrain"`` ground, what ``exact_plant`` of
csrc/substep_kernel.cu equals on the card) against the op-graph step it
replaces there, ``dynamics.step`` with exact bilinear contact, on OpenDOG's
terrain scene at K=1 x 10 substeps of 2 ms; the lookup alone against
``dynamics._contact_geometry`` at chosen sphere centres; and the kernel's
host build (csrc/substep_host.cpp: the serial oracle and the warp design)
against the plain version, as tests/test_torch_substep_warp.py holds
K1-K4.  The kernel itself is compared with the plain version on the card
by tests/test_torch_gpu.py.

The plain version and the op-graph step compute the same contact in another
order (the normal's norm, the friction's |v - (v.n) n|, J C J^T as a
matrix product): from a settled stand under perturbed controls they part
by at most 2.4e-7 qpos and 9.3e-6 qvel over 20 ticks (6.5e-6 on flat
ground); the tolerances below are about four times that.
"""
import ctypes
import shutil

import numpy as np
import pytest
import torch

from opendog_tpu_torch import assets
from opendog_tpu_torch.ops import build, cuda_step, scalar_core
from opendog_tpu_torch.physics import State, Terrain, dynamics, make_state
from opendog_tpu_torch.physics import terrain as terrain_lib
from chip_smoke import EXACT_PLANT_CASES, exact_plant_batch

torch.set_num_threads(1)

TOL = dict(qpos=1e-6, qvel=4e-5)  # plain against the op-graph step
TIGHT = dict(qpos=1e-5, qvel=1e-4)  # host build against the plain version
N_SUB = 10
LANES = 4


@pytest.fixture(scope="module")
def scene():
    """OpenDOG's terrain scene on the generated terrain of seed 0 (rough),
    and its keyframe settled on it for 25 ticks of the op-graph step under
    the clipped home control: (model, terrain, settled state, hold)."""
    m = assets.load_opendog("terrain", device="cpu")
    terr = terrain_lib.generate_terrain(m, torch.Generator().manual_seed(0))
    h0 = float(dynamics._terrain_height_normal(m, terr, torch.zeros(1, 2))[0])
    rng = m.actuator_ctrlrange
    hold = torch.clamp(m.key_ctrl[0], rng[:, 0], rng[:, 1])
    st = make_state(m, "home")
    st.qpos[2] += h0
    for _ in range(25):
        st = dynamics.step(m, st, hold, terr, n_substeps=N_SUB)[0]
    return m, terr, st, hold


def _placed(scene, case):
    """LANES copies of the settled stand, each with its own control (hold
    plus N(0, 0.05) rad): where it settled ("stand"); over the static box
    on a flat grid at z = 0, sunk 2-14 mm into the box top at four xy
    offsets, so that paw spheres lie inside the box and others just beside
    it ("box"); or 0.3 m past the heightfield's clipped edge in x and y,
    on the clipped ground ("edge").  (qpos (K, nq), qvel, ctrl, terrain)."""
    m, terr, st, hold = scene
    g = torch.Generator().manual_seed(7)
    qpos = st.qpos[None].repeat(LANES, 1)
    qvel = st.qvel[None].repeat(LANES, 1)
    ctrl = hold[None] + 0.05 * torch.randn(LANES, m.nu, generator=g)
    h0 = dynamics._terrain_height_normal(m, terr, qpos[:, :2])[0]
    if case == "box":
        terr = Terrain(height=torch.zeros_like(terr.height))
        top = float(m.wbox_pos[0, 2] + m.wbox_size[0, 2])
        qpos[:, 0] += float(m.wbox_pos[0, 0]) + torch.tensor(
            [0.0, 0.05, -0.1, 0.12])
        qpos[:, 1] += torch.tensor([0.0, -0.1, 0.15, 0.05])
        qpos[:, 2] += top - h0 - torch.tensor([0.002, 0.006, 0.01, 0.014])
    elif case == "edge":
        sx, sy = (float(v) for v in m.hfield_size[:2])
        qpos[:, 0] += torch.tensor([sx + 0.3, -sx - 0.3, 0.0, sx + 0.3])
        qpos[:, 1] += torch.tensor([0.0, 0.0, sy + 0.3, -sy - 0.3])
        qpos[:, 2] += dynamics._terrain_height_normal(
            m, terr, qpos[:, :2])[0] - h0
    return qpos, qvel, ctrl, terr


def _centers(m, qpos, xpos=None, xquat=None):
    """The collision spheres' centres (..., ngeom, 3) of ``qpos``, or of
    the body poses ``xpos``, ``xquat``, as the op-graph step computes
    them."""
    if xpos is None:
        xpos, xquat = dynamics.fk(m, qpos)
    R = dynamics.spatial.quat_to_mat(xquat)
    gb = m.geom_body.long()
    return xpos[..., gb, :] + torch.einsum("...gij,gj->...gi",
                                           R[..., gb, :, :], m.geom_pos)


@pytest.mark.parametrize("case", ["stand", "box", "edge"])
def test_plain_terrain_ground_matches_op_step(scene, case):
    """Two ticks of 10 x 2 ms of the plain version on the terrain ground
    against ``dynamics.step`` on the same terrain from the same states and
    controls, each tick from the op-graph step's state, lane by lane: within
    TOL plus four times what the op-graph step's own result moves when the
    base position moves by one float32 ulp (the box and edge cases start
    with an impact, where the stiff contact magnifies a rounding: measured
    up to 9.5e-7 qpos and 8.7e-5 qvel against a move of 1.8e-6 and 1.0e-4).
    The box case has sphere centres inside the box and contact on it, the
    edge case centres past the clipped edge of the grid."""
    m = scene[0]
    qpos, qvel, ctrl, terr = _placed(scene, case)
    c = _centers(m, qpos)
    if case == "box":
        rel = (c - m.wbox_pos[0]).abs()
        assert (rel <= m.wbox_size[0]).all(-1).any()     # inside the box
        assert ((rel <= m.wbox_size[0] + 0.02).all(-1)
                & (rel > m.wbox_size[0]).any(-1)).any()  # just outside
    if case == "edge":
        sx, sy = (float(v) for v in m.hfield_size[:2])
        assert ((c[..., 0].abs() > sx) | (c[..., 1].abs() > sy)).all(-1).all()
    plain = cuda_step.build_plain_substep(m, m.timestep, N_SUB,
                                          scalar_core.TERRAIN)

    def op_step(qp):
        return dynamics.step(m, State(qpos=qp, qvel=qvel,
                                      time=torch.zeros(LANES)),
                             ctrl, terr, n_substeps=N_SUB)[0]

    for _ in range(2):
        want = op_step(qpos)
        shifted = qpos.clone()
        shifted[:, :3] = torch.nextafter(shifted[:, :3], shifted[:, :3] + 1)
        moved = op_step(shifted)
        qp, qv = plain(qpos.T.contiguous(), qvel.T.contiguous(),
                       ctrl.T.contiguous(), terr.height)
        for name, got, w, v in (("qpos", qp.T, want.qpos, moved.qpos),
                                ("qvel", qv.T, want.qvel, moved.qvel)):
            err = (got - w).abs().max(dim=1).values
            spread = (v - w).abs().max(dim=1).values
            assert (err <= TOL[name] + 4 * spread).all(), (case, name, err,
                                                           spread)
        qpos, qvel = want.qpos, want.qvel
    assert float(qvel.abs().max()) > 1e-3  # it moved


def _body_coord(c, gp):
    """A float32 body coordinate x with x + gp == c in float32."""
    x = (c - gp).reshape(1)
    for _ in range(64):
        if bool(x + gp == c):
            return x[0]
        x = torch.nextafter(x, x + (1.0 if bool(x + gp < c) else -1.0))
    raise AssertionError("no float32 body coordinate found")


def _tie_center(m):
    """A sphere centre inside the box where the x and the z face are
    equally near in float32 (size - |rel|, as both packages compute it):
    rel_x a multiple of the ulp of the box's x, F = size_x - rel_x, the
    centre at height F, so that size_z - |F - pos_z| is F exactly.  The
    first of equal faces, x, must win."""
    pos, size = m.wbox_pos[0], m.wbox_size[0]
    rel_x = torch.tensor(round(0.1 * 2 ** 23) / 2 ** 23)
    face = size[0] - rel_x
    c = torch.stack([pos[0] + rel_x, pos[1], face])
    assert size[2] - (c[2] - pos[2]).abs() == face == size[0] - (
        c[0] - pos[0]).abs()
    return c


def test_ground_lookup_matches_contact_geometry(host_lib, scene):
    """``scalar_core.terrain_ground`` against ``dynamics._contact_geometry``
    at chosen centres of geom 0's sphere (its body posed with the identity
    rotation), on the terrain with its heights zeroed around the box (which
    then stands proud): on the terrain, past each clipped edge, inside the
    box near each face, just outside it beside a face, an edge and a
    corner, and on an exact tie of two faces.  phi and n agree to 1e-6; on
    the tie both take the x face exactly, and inside the box the normal is
    a unit axis.  The kernel's lookup (``sc_terrain_ground``, its host
    build) equals the plain version's bit for bit at every centre."""
    m, terr, _, _ = scene
    pos, size = m.wbox_pos[0], m.wbox_size[0]
    sx = float(m.hfield_size[0])
    xs = torch.linspace(-sx, sx, terr.height.shape[1])
    near = ((xs[None, :] - float(pos[0])).abs() < 0.6) & (
        xs[:, None].abs() < 0.6)
    terr = Terrain(height=torch.where(near, 0.0, terr.height))
    pts = [(0.3, -0.2, 0.1), (sx + 0.4, 0.2, 0.2), (-sx - 1.0, sx + 2.0, 0.2),
           (0.5, -sx - 0.01, 0.15)]
    inside = [pos + torch.tensor(d) for d in
              ((0.1, 0.0, 0.0), (0.0, -0.2, 0.01), (0.0, 0.05, 0.03),
               (-0.12, 0.1, -0.02))]
    outside = [pos + size * torch.tensor(d) for d in
               ((1.05, 0.0, 0.2), (-1.02, 1.03, 0.0), (1.01, -1.02, 1.03),
                (0.3, 0.1, 1.01))]
    g = 0
    gp = m.geom_pos[g]
    rad = float(m.geom_radius[g])
    b = int(m.geom_body_static[g])
    tie = _tie_center(m)
    body = torch.stack([torch.tensor(p) for p in pts] + inside + outside
                       + [tie]) - gp
    body[-1] = torch.stack([_body_coord(tie[k], gp[k]) for k in range(3)])
    K = len(body)
    xpos = torch.zeros(K, m.nbody, 3)
    xpos[:, b] = body
    xquat = torch.zeros(K, m.nbody, 4)
    xquat[..., 0] = 1.0
    phi_w, n_w, _, _ = dynamics._contact_geometry(m, xpos, xquat, terr)
    centers = _centers(m, None, xpos, xquat)[:, g]
    assert torch.equal(centers[-1], tie)
    gc = scalar_core.ground_constants(m, *terr.height.shape)
    n, phi = scalar_core.terrain_ground(gc, terr.height, centers.unbind(1),
                                        rad, torch.zeros(K))
    n = torch.stack(n, dim=-1)
    # the kernel's lookup (its host build) equals the plain version's
    n_h, phi_h = torch.empty(3, K), torch.empty(K)
    assert host_lib.exact_plant_ground_host(
        ctypes.addressof(cuda_step.ground_table(m, *terr.height.shape)),
        terr.height.data_ptr(), centers.T.contiguous().data_ptr(),
        torch.full((K,), rad).data_ptr(), n_h.data_ptr(), phi_h.data_ptr(),
        K) == 0
    assert torch.equal(phi_h, phi) and torch.equal(n_h.T, n)
    np.testing.assert_allclose(phi.numpy(), phi_w[:, g].numpy(), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(n.numpy(), n_w[:, g].numpy(), rtol=0,
                               atol=1e-6)
    k_in = slice(len(pts), len(pts) + len(inside))
    assert (phi[k_in] < -rad).all()
    assert ((n[k_in].abs() == 1.0).sum(-1) == 1).all()
    assert (phi[len(pts) + len(inside):-1] > -rad).all()
    assert torch.equal(n[-1], torch.tensor([1.0, 0.0, 0.0]))
    assert torch.equal(n_w[-1, g], torch.tensor([1.0, 0.0, 0.0]))


# -- the host build of the kernel -------------------------------------------

@pytest.fixture(scope="module")
def host_lib():
    """g++ build of csrc/substep_host.cpp (a test aid: no entry point of
    the package reaches it), shared with tests/test_torch_substep_warp.py."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    built = build.build_library("substep_host", "substep_host.cpp", "g++",
                                build.GXX_FLAGS)
    lib = ctypes.CDLL(built.path)
    lib.exact_plant_host.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
    lib.exact_plant_host.restype = ctypes.c_int
    lib.exact_plant_ground_size.restype = ctypes.c_int
    lib.exact_plant_ground_host.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int]
    lib.exact_plant_ground_host.restype = ctypes.c_int
    return lib


def _host(lib, m, args, design):
    """The exact plant on the host: design 0 the serial oracle, 1 the warp
    design, 2 its lanes in reverse."""
    qp, qv, ct, heights = args
    table = cuda_step.substep_table(m, m.timestep)
    ground = cuda_step.ground_table(m, *heights.shape)
    out_p, out_v = torch.empty_like(qp), torch.empty_like(qv)
    rc = lib.exact_plant_host(
        ctypes.addressof(table), ctypes.addressof(ground), heights.data_ptr(),
        qp.data_ptr(), qv.data_ptr(), ct.data_ptr(), out_p.data_ptr(),
        out_v.data_ptr(), qp.shape[1], N_SUB, design)
    assert rc == 0
    return out_p, out_v


def _batch(scene, case, K=8):
    m, terr = scene[0], scene[1]
    return [torch.from_numpy(np.ascontiguousarray(a))
            for a in exact_plant_batch(m, terr, K, case)]


def test_ground_table_layout(host_lib, scene):
    """The ground table's ctypes mirror has the host build's size, and
    holds the scene's one box and the lookup's float32 constants."""
    m, terr = scene[0], scene[1]
    _, layout = cuda_step.table_layout("SUBSTEP_GROUND_FIELDS")
    assert ctypes.sizeof(layout) == host_lib.exact_plant_ground_size()
    t = cuda_step.ground_table(m, *terr.height.shape)
    assert (t.nrow, t.ncol, t.nbox) == (100, 100, 1)
    assert list(t.box_pos[:3]) == [float(v) for v in m.wbox_pos[0]]
    assert t.cell_x == float(np.float32(10.0) / np.float32(99.0))
    with pytest.raises(ValueError, match="SC_NBOX_MAX"):
        n = cuda_step.table_layout()[0]["SC_NBOX_MAX"] + 1
        cuda_step.ground_table(m.replace(wbox_pos=m.wbox_pos.repeat(n, 1),
                                         wbox_size=m.wbox_size.repeat(n, 1)),
                               100, 100)


@pytest.mark.parametrize("case", EXACT_PLANT_CASES)
def test_exact_plant_host_designs_agree_and_match_plain(host_lib, scene,
                                                        case):
    """K=8 random OpenDOG states of each case, 10 x 2 ms: the warp design,
    its lanes in order and in reverse on a NaN-filled workspace, equals the
    serial oracle bit for bit, is finite, and matches the plain version to
    TIGHT plus four times what the plain version's own result moves under
    a 1e-7 relative change of qvel (libm's sinf / cosf against
    PyTorch's)."""
    m = scene[0]
    args = _batch(scene, case)
    want = _host(host_lib, m, args, 0)
    for design in (1, 2):
        got = _host(host_lib, m, args, design)
        assert torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    plain = cuda_step.build_plain_substep(m, m.timestep, N_SUB,
                                          scalar_core.TERRAIN)
    ref = plain(*args)
    nudged = plain(args[0], args[1] * (1 + 1e-7), *args[2:])
    for name, g, w, v in zip(("qpos", "qvel"), want, ref, nudged):
        spread = (w - v).abs().max(dim=0).values
        err = (g - w).abs().max(dim=0).values
        assert (err <= TIGHT[name] + 4 * spread).all(), (name, err, spread)


def test_exact_plant_refuses_what_it_cannot_compute(scene):
    """The wrapper refuses one grid per env, heights on another device or
    in another precision, and a model with the progressive contact
    impedance; on the CPU it runs the plain version."""
    m, terr = scene[0], scene[1]
    with pytest.raises(ValueError, match="one \\(nrow, ncol\\) grid"):
        cuda_step.ExactPlant(m, m.timestep, N_SUB, terr.height[None], "cpu")
    with pytest.raises(ValueError, match="float32"):
        cuda_step.ExactPlant(m, m.timestep, N_SUB, terr.height.double(),
                             "cpu")
    with pytest.raises(ValueError, match="impedance"):
        cuda_step.ExactPlant(m.replace(geom_imp_dmin=torch.ones(m.ngeom)),
                             m.timestep, N_SUB, terr.height, "cpu")
    qp, qv, ct, _ = _batch(scene, "terrain", K=1)
    got = cuda_step.ExactPlant(m, m.timestep, 1, terr.height, "cpu")(qp, qv,
                                                                     ct)
    want = cuda_step.build_plain_substep(m, m.timestep, 1,
                                         scalar_core.TERRAIN)(qp, qv, ct,
                                                              terr.height)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
