"""iLQR / DDP: the shooting branch of the MPC engine (BASELINE config 3:
whole-body MPC with a 1 s horizon, 1 Hz replan + 50 Hz tracking).

Port of ``opendog_tpu/solvers/ilqr.py``, on one device or with the
associative Riccati sweep sharded over the horizon on a mesh of ranks
(``sharded_suffix_scan``, ``make_ilqr(..., mesh=)``):

* the dynamics linearisations A_t, B_t of the whole horizon come from one
  ``torch.func.vmap(jacfwd)`` over the rollout, the cost expansion from
  ``grad`` / ``hessian`` vmapped the same way;
* the backward Riccati recursion runs sequentially (``"scan"``) or as a
  parallel-in-time value-function composition (``"associative"``, a
  log-depth reverse associative scan written here, since PyTorch has no
  ``associative_scan``);
* the line search rolls all step sizes out at once, one batch through the
  batch-first step, and picks the best on the device.

State convention: x = [qpos; qvel], treated as Euclidean for the
linearisation.  Stage time is threaded through the horizon as a per-stage
constant (t0 + k * stage_dt, never differentiated), so phase-indexed costs
(gait references, ``costs.ContactSchedule``) bind the right phase at every
horizon step.

A solve reads nothing back to the host: the iteration count is fixed, the
line-search pick and the regularisation update are ``argmin`` / ``where``
on the device, and the small factorizations are the ``_ex`` forms with no
``info`` check, run by cuSOLVER / cuBLAS on the card
(``device.use_cusolver``).  So each of its pieces (a rollout stage, a
line-search stage, the derivative pass, the backward pass, the pick) can
be captured in a CUDA graph once and replayed from the Python loop of the
solve (``make_ilqr(..., graphs=True)``, the default on CUDA): the
counterpart of the JAX package's jitted solve.
"""
from __future__ import annotations

import collections
import functools
from dataclasses import dataclass
from typing import Callable, Optional

import torch
from torch.func import grad, hessian, jacfwd, vmap

from ..device import resolve_device, use_cusolver, use_full_fp32
from ..parallel import collectives
from ..physics import State, Terrain, dynamics
from .graph import GraphedTick

RICCATI = ("scan", "associative")


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ij,...j->...i", M, v)


def _mT(M: torch.Tensor) -> torch.Tensor:
    return M.transpose(-1, -2)


def _solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_ex(A, B)[0]


def _vf_combine(earlier, later):
    """Associative composition of two value-function blocks (F, c, C, eta,
    J).  Every operand may carry leading batch axes, and the two sides
    broadcast against each other."""
    F1, c1, C1, n1, J1 = earlier
    F2, c2, C2, n2, J2 = later
    I = torch.eye(F1.shape[-1], dtype=F1.dtype, device=F1.device)
    A1 = I + C1 @ J2
    A2 = I + J2 @ C1
    X = _solve(A1, F1)
    Y = _solve(A1, C1)
    Z = _solve(A2, J2)
    F12 = F2 @ X
    c12 = _mv(F2, _solve(A1, (c1 + _mv(C1, n2))[..., None])[..., 0]) + c2
    C12 = F2 @ Y @ _mT(F2) + C2
    n12 = _mv(_mT(F1), _solve(A2, (n2 - _mv(J2, c1))[..., None])[..., 0]) + n1
    J12 = _mT(F1) @ Z @ F1 + J1
    return (F12, c12, C12, n12, J12)


def _vf_identity(nx: int, dtype=torch.float32, device=None):
    """Identity element of ``_vf_combine``: F = I, everything else zero."""
    z = torch.zeros(nx, nx, dtype=dtype, device=device)
    return (torch.eye(nx, dtype=dtype, device=device),
            torch.zeros(nx, dtype=dtype, device=device), z,
            torch.zeros(nx, dtype=dtype, device=device), z)


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a[0], b[0], a[1], b[1], ... along axis 0 (len(a) is len(b) or one
    more)."""
    n = b.shape[0]
    pairs = torch.stack([a[:n], b], dim=1).reshape((2 * n,) + a.shape[1:])
    return pairs if a.shape[0] == n else torch.cat([pairs, a[n:]], dim=0)


def _associative_scan(fn, elems):
    """Inclusive scan of ``fn`` along axis 0 of every tensor of ``elems``,
    in log depth: the odd/even recursion of ``jax.lax.associative_scan``,
    so its combines group the elements as JAX's do."""
    n = elems[0].shape[0]
    if n < 2:
        return elems
    reduced = fn(tuple(e[0:-1:2] for e in elems),
                 tuple(e[1::2] for e in elems))
    odd = _associative_scan(fn, reduced)
    if n % 2 == 0:
        even = fn(tuple(e[:-1] for e in odd), tuple(e[2::2] for e in elems))
    else:
        even = fn(odd, tuple(e[2::2] for e in elems))
    even = tuple(torch.cat([e[:1], r], dim=0) for e, r in zip(elems, even))
    return tuple(_interleave(e, o) for e, o in zip(even, odd))


def _suffix_scan(elems):
    """Reverse (suffix) associative scan of value-function blocks: the
    sequence is flipped and scanned forward, so the combine's first operand
    is the later-in-time block, and the roles are swapped back so that the
    earlier block stays the outer operator."""
    flipped = tuple(e.flip(0) for e in elems)
    out = _associative_scan(lambda a, b: _vf_combine(b, a), flipped)
    return tuple(e.flip(0) for e in out)


def _pack(elems) -> torch.Tensor:
    """(L, ...) value-function blocks as one (L, 3 nx^2 + 2 nx) tensor."""
    return torch.cat([e.reshape(e.shape[0], -1) for e in elems], dim=1)


def _unpack(flat: torch.Tensor, like):
    """``_pack``'s inverse, the blocks shaped as ``like``'s."""
    sizes = [e[0].numel() for e in like]
    return tuple(x.reshape((flat.shape[0],) + tuple(e.shape[1:]))
                 for x, e in zip(flat.split(sizes, dim=1), like))


def sharded_suffix_scan(elems, mesh):
    """The reverse associative scan of value-function blocks, sharded over
    the horizon on ``mesh`` (one axis): the two-level blocked scan
    of ``ilqr.py:82-128``.  Every rank takes the same global blocks (L,
    ...), pads them with the identity to a multiple of n, runs the suffix
    scan of its own block, gathers the n block totals (one ``all_gather``),
    composes the n + 1 block aggregates redundantly, and finishes its block
    with one combine with the product of all later blocks.  The finished
    blocks are gathered again, so every rank returns the whole (L, ...)
    scan; equal to ``_suffix_scan`` up to the order of the compositions, and
    bit for bit at one rank."""
    n, L = mesh.size, elems[0].shape[0]
    ident = _vf_identity(elems[0].shape[-1], elems[0].dtype,
                         elems[0].device)
    pad = (-L) % n
    if pad:
        elems = tuple(torch.cat([e, i.expand((pad,) + i.shape)], dim=0)
                      for e, i in zip(elems, ident))
    b = (L + pad) // n
    i = collectives.axis_index(mesh)
    local = _suffix_scan(tuple(e[i * b:(i + 1) * b] for e in elems))
    totals = _unpack(collectives.all_gather(
        _pack(tuple(t[:1] for t in local)), mesh), local)
    ext = tuple(torch.cat([g, e[None]], dim=0)
                for g, e in zip(totals, ident))
    # exclusive suffix of this block: the product of all later blocks
    agg = tuple(a[i + 1].expand_as(e)
                for a, e in zip(_suffix_scan(ext), local))
    done = _vf_combine(local, agg)
    comp = _unpack(collectives.all_gather(_pack(done), mesh), done)
    return tuple(c[:L] for c in comp)


def _cho_solve(Q: torch.Tensor, *rhs: torch.Tensor):
    """Solves ``Q z = r`` for each right-hand side through one Cholesky
    factor of ``Q`` (``cho_factor`` / ``cho_solve``); a vector ``r`` gives a
    vector.  A factor that fails gives NaNs, as in the JAX package."""
    L = torch.linalg.cholesky_ex(Q)[0]
    return tuple(torch.cholesky_solve(r[..., None], L)[..., 0]
                 if r.dim() == Q.dim() - 1 else torch.cholesky_solve(r, L)
                 for r in rhs)


def associative_lqr_gains(A, B, lx, lu, lxx, luu, lux, vx, vxx, reg,
                          mesh=None):
    """O(log H)-depth LQR backward pass via associative value-function
    composition, standalone so that it can be held against the sequential
    recursion.  With ``mesh`` the horizon axis is sharded over its ranks
    (:func:`sharded_suffix_scan`), every rank returning the whole result.
    Returns (k (H, nu), K (H, nu, nx), dV (H,))."""
    nx, nu = A.shape[1], B.shape[2]
    eye_u = torch.eye(nu, dtype=A.dtype, device=A.device)
    R = luu + reg * eye_u[None]
    Rinv = torch.linalg.inv_ex(R)[0]
    RinvM = torch.einsum("huv,hvx->hux", Rinv, lux)
    Rinvr = torch.einsum("huv,hv->hu", Rinv, lu)
    F = A - torch.einsum("hxu,huy->hxy", B, RinvM)
    c = -torch.einsum("hxu,hu->hx", B, Rinvr)
    C = torch.einsum("hxu,huv,hyv->hxy", B, Rinv, B)
    J = lxx - torch.einsum("hux,huy->hxy", lux, RinvM)
    eta = -(lx - torch.einsum("hux,hu->hx", lux, Rinvr))

    zf = A.new_zeros((1, nx, nx))
    elems = (torch.cat([F, zf], dim=0),
             torch.cat([c, A.new_zeros((1, nx))], dim=0),
             torch.cat([C, zf], dim=0),
             torch.cat([eta, -vx[None]], dim=0),
             torch.cat([J, vxx[None]], dim=0))
    comp = (_suffix_scan(elems) if mesh is None
            else sharded_suffix_scan(elems, mesh))
    Vxx_next = comp[4][1:]
    Vx_next = -comp[3][1:]

    Bt = _mT(B)
    Qu = lu + _mv(Bt, Vx_next)
    Quu = luu + Bt @ Vxx_next @ B + reg * eye_u
    Qux = lux + Bt @ Vxx_next @ A
    k, K = _cho_solve(Quu, Qu, Qux)
    k, K = -k, -K
    dV = (k * Qu).sum(-1) + 0.5 * (k * _mv(Quu, k)).sum(-1)
    return k, K, dV


def sequential_lqr_gains(A, B, lx, lu, lxx, luu, lux, vx, vxx, reg):
    """The classic sequential Riccati recursion (O(H) depth), the
    counterpart of ``associative_lqr_gains``.  Returns (k (H, nu), K (H, nu,
    nx), dV (H,))."""
    nu = B.shape[2]
    eye_u = torch.eye(nu, dtype=A.dtype, device=A.device)
    Vx, Vxx = vx, vxx
    ks, Ks, dVs = [], [], []
    for t in reversed(range(A.shape[0])):
        A_t, B_t = A[t], B[t]
        Qx = lx[t] + A_t.T @ Vx
        Qu = lu[t] + B_t.T @ Vx
        Qxx = lxx[t] + A_t.T @ Vxx @ A_t
        Quu = luu[t] + B_t.T @ Vxx @ B_t
        Qux = lux[t] + B_t.T @ Vxx @ A_t
        k, K = _cho_solve(Quu + reg * eye_u, Qu, Qux)
        k, K = -k, -K
        Vx = Qx + K.T @ Quu @ k + K.T @ Qu + Qux.T @ k
        Vxx = Qxx + K.T @ Quu @ K + K.T @ Qux + Qux.T @ K
        Vxx = 0.5 * (Vxx + Vxx.T)
        ks.append(k)
        Ks.append(K)
        dVs.append(k @ Qu + 0.5 * k @ (Quu @ k))
    return (torch.stack(ks[::-1]), torch.stack(Ks[::-1]),
            torch.stack(dVs[::-1]))


def _pick(costs: torch.Tensor, cost: torch.Tensor):
    """The line search's choice among candidate costs (n_alpha,) against the
    current cost, on the device: the index of the first minimum (of the
    first NaN, if there is one, as ``jnp.argmin`` has it) and whether it
    improves on ``cost`` (a NaN never does)."""
    best = torch.argmin(costs)
    c_best = torch.index_select(costs, 0, best.view(1))[0]
    return best, c_best, c_best < cost


@dataclass(frozen=True)
class ILQRConfig:
    horizon: int = 50            # control steps
    n_substeps: int = 4
    rollout_dt: float = 0.005
    iterations: int = 10
    reg_init: float = 1e-3       # Levenberg-Marquardt regularisation
    reg_factor: float = 10.0
    reg_max: float = 1e6
    line_search_alphas: tuple = (1.0, 0.5, 0.25, 0.1, 0.03)
    riccati: str = "scan"        # "scan" | "associative"
    u_cost_reg: float = 1e-3     # quadratic control regularisation added
    # float32 products throughout, TF32 off (device.use_full_fp32): the
    # JAX package's "highest", the only precision the port runs
    precision: str = "highest"


class _Pieces:
    """Runs a solver piece ``fn(*inputs)`` eagerly, or, with ``graphs``,
    replays it from a CUDA graph captured at its first call
    (:class:`~.graph.GraphedTick`, one per piece and shape).  A replay's
    outputs are static tensors that its next replay overwrites: callers
    copy what they keep, in both modes alike."""

    def __init__(self, device, graphs: bool):
        self.device, self.graphs = device, graphs
        self.captured = {}  # fn -> GraphedTick
        self.calls = collections.Counter()  # fn -> calls

    def __call__(self, fn: Callable, *inputs: torch.Tensor):
        self.calls[fn] += 1
        if not self.graphs:
            return fn(*inputs)
        g = self.captured.get(fn)
        if g is None:
            g = self.captured[fn] = GraphedTick(fn, inputs, self.device)
        return g(*inputs)


def make_ilqr(
    model,
    step_cost: Callable,  # (state, ctrl, prev_ctrl) -> cost, batch-first
    config: ILQRConfig = ILQRConfig(),
    terminal_cost: Optional[Callable] = None,
    terrain: Optional[Terrain] = None,
    device=None,
    graphs: Optional[bool] = None,
    mesh=None,
):
    """Build ``solve(state, U_init) -> (U*, X*, stats)`` on ``device`` (CUDA
    unless the caller names another; with ``mesh``, the mesh's).  ``stats``
    holds ``cost``, ``initial_cost``, ``cost_trace`` (the cost after each
    iteration), ``pick_trace`` (the index of the step size taken at each
    iteration, -1 where none improved) and the final gains ``k_ff`` /
    ``K_fb`` along the returned trajectory, and ``line_search_costs``
    (iterations, n_alpha), the cost of each step size at each iteration.

    ``graphs`` (default: on CUDA) replays each piece of the solve from a
    CUDA graph captured at its first call; the results equal the eager
    solve's bit for bit.  Only on CUDA: another device raises.

    ``mesh`` (one axis) shards the associative Riccati sweep
    over the horizon (:func:`sharded_suffix_scan`); it needs
    ``riccati="associative"``, and graphs of it need an NCCL group (a gloo
    mesh with graphs raises: pass ``graphs=False``)."""
    if config.riccati not in RICCATI:
        raise ValueError(f"riccati must be one of {RICCATI}, got "
                         f"{config.riccati!r}")
    if mesh is not None:
        if config.riccati != "associative":
            raise ValueError("horizon sharding needs the associative "
                             "Riccati sweep (riccati='associative')")
        device = mesh.on_device(device)
    if config.precision != "highest":
        raise ValueError("the port runs float32 products in full float32 "
                         f"only (precision='highest'), got "
                         f"{config.precision!r}")
    device = resolve_device(device)
    if graphs is None:
        graphs = device.type == "cuda"
    if graphs and device.type != "cuda":
        raise ValueError(f"CUDA graphs need a CUDA device, got {device}")
    if graphs:
        collectives.require_capturable(mesh, "make_ilqr(graphs=True)")
    use_full_fp32()
    if device.type == "cuda":
        use_cusolver()
    model = model.to(device)
    if terrain is not None:
        terrain = terrain.to(device)
    nq, nu, H = model.nq, model.nu, config.horizon
    rollout_model = (model.replace(timestep=config.rollout_dt)
                     if config.rollout_dt else model)
    lo = model.actuator_ctrlrange[:, 0]
    hi = model.actuator_ctrlrange[:, 1]
    stage_dt = float(config.n_substeps) * float(
        config.rollout_dt if config.rollout_dt else model.timestep)
    f32 = dict(dtype=torch.float32, device=device)
    alphas = torch.tensor(config.line_search_alphas, **f32)[:, None]
    steps = stage_dt * torch.arange(H + 1, **f32)
    zeros_u = torch.zeros(nu, **f32)
    reg_init = torch.tensor(config.reg_init, **f32)
    run = _Pieces(device, graphs)

    def f(x, u):
        """One control stage of the rollout model: (..., nx), (..., nu)."""
        st = State(qpos=x[..., :nq], qvel=x[..., nq:],
                   time=x.new_zeros(x.shape[:-1]))
        st2, _ = dynamics.step(rollout_model, st, u, terrain,
                               n_substeps=config.n_substeps)
        return torch.cat([st2.qpos, st2.qvel], dim=-1)

    def _as_state(x, t):
        # time is a per-stage constant, never differentiated
        return State(qpos=x[..., :nq], qvel=x[..., nq:], time=t)

    def stage_cost(x, u, u_prev, t):
        return (step_cost(_as_state(x, t), u, u_prev)
                + config.u_cost_reg * torch.sum(torch.square(u), dim=-1))

    def term_cost(x, t):
        if terminal_cost is not None:
            return terminal_cost(_as_state(x, t))
        return step_cost(_as_state(x, t), zeros_u, zeros_u)

    def _prev(U):
        return torch.cat([U[..., :1, :], U[..., :-1, :]], dim=-2)

    def total_cost(X, U, times):
        """X (..., H+1, nx), U (..., H, nu) -> (...)."""
        cs = stage_cost(X[..., :-1, :], U, _prev(U),
                        times[:-1].expand(U.shape[:-1]))
        return (torch.sum(cs, dim=-1)
                + term_cost(X[..., -1, :], times[-1].expand(X.shape[:-2])))

    # ---------------- derivatives (batched over the horizon) -------------
    jac_f = vmap(jacfwd(f, argnums=(0, 1)))
    grad_l = vmap(grad(stage_cost, argnums=(0, 1)))
    hess_l = vmap(hessian(stage_cost, argnums=(0, 1)))
    grad_v = grad(term_cost)
    hess_v = hessian(term_cost)

    def expand(X, U, times):
        """The dynamics Jacobians and the cost expansion along (X, U)."""
        A, B = jac_f(X[:-1], U)
        args = (X[:-1], U, _prev(U), times[:-1])
        lx, lu = grad_l(*args)
        (lxx, _), (lux, luu) = hess_l(*args)
        return (A, B, lx, lu, lxx, luu, lux, grad_v(X[-1], times[-1]),
                hess_v(X[-1], times[-1]))

    # ---------------- backward passes ------------------------------------
    gains = (functools.partial(associative_lqr_gains, mesh=mesh)
             if config.riccati == "associative" else sequential_lqr_gains)

    def backward(A, B, lx, lu, lxx, luu, lux, vx, vxx, reg):
        k, K, dV = gains(A, B, lx, lu, lxx, luu, lux, vx, vxx, reg)
        return k, K, torch.sum(dV)

    # ---------------- the pieces the loops replay --------------------------
    def line_stage(x, X_t, U_t, k_t, K_t):
        """One stage of every step size's forward pass, (n_alpha, nx)."""
        u = U_t + alphas * k_t + _mv(K_t, x - X_t)
        u = torch.clamp(u, lo, hi)
        return f(x, u), u

    def select(Xc, Uc, U, cost, reg, times):
        """The best step size against the current plan; the
        regularisation falls after a step that improved and rises
        otherwise."""
        costs = total_cost(Xc, Uc, times)
        best, c_best, improved = _pick(costs, cost)
        U_best = torch.index_select(Uc, 0, best.view(1))[0]
        reg_next = torch.where(
            improved, torch.clamp(reg / config.reg_factor, min=1e-9),
            torch.clamp(reg * config.reg_factor, max=config.reg_max))
        return (torch.where(improved, U_best, U),
                torch.where(improved, c_best, cost), reg_next,
                torch.where(improved, best, -1), costs)

    def rollout(x0, U):
        X = x0.new_empty((H + 1,) + x0.shape)
        X[0] = x0
        for t in range(H):
            X[t + 1] = run(f, X[t], U[t])
        return X

    def forward(x0, X, U, k, K):
        n = alphas.shape[0]
        Xc = x0.new_empty((n, H + 1) + x0.shape)
        Uc = U.new_empty((n,) + U.shape)
        Xc[:, 0] = x0
        for t in range(H):
            Xc[:, t + 1], Uc[:, t] = run(line_stage, Xc[:, t], X[t], U[t],
                                         k[t], K[t])
        return Xc, Uc

    def solve(state: State, U_init: torch.Tensor):
        x0 = torch.cat([state.qpos, state.qvel]).to(device)
        # stage times along the horizon: phase-indexed costs bind here
        times = state.time.to(device) + steps
        U = U_init.to(device)
        cost0 = run(total_cost, rollout(x0, U), U, times).clone()
        cost, reg = cost0, reg_init
        trace, picks, tried = [cost0], [reg_init.long()], [alphas[:, 0]]
        for _ in range(config.iterations):
            X = rollout(x0, U)
            e = run(expand, X, U, times)
            k, K, _ = run(backward, *e, reg)
            Xc, Uc = forward(x0, X, U, k, K)
            U, cost, reg, pick, costs = (
                v.clone() for v in run(select, Xc, Uc, U, cost, reg, times))
            trace.append(cost)
            picks.append(pick)
            tried.append(costs)
        X = rollout(x0, U)
        # the final time-varying LQR gains along (X, U): one more backward
        # pass at the converged plan, for the replan + track cycle
        k_ff, K_fb, _ = (v.clone() for v in run(
            backward, *run(expand, X, U, times), reg_init))
        # each trace starts with a placeholder, so that no iterations stack
        return U, X, dict(cost=cost, initial_cost=cost0,
                          cost_trace=torch.stack(trace)[1:],
                          pick_trace=torch.stack(picks)[1:],
                          line_search_costs=torch.stack(tried)[1:],
                          k_ff=k_ff, K_fb=K_fb)

    solve.pieces, solve.expand, solve.total_cost = run, expand, total_cost
    return solve
