"""What the port's application scripts (``scripts/torch_*.py``, the
counterparts of the JAX package's jump, landing, turn, iLQR gait, lag sweep,
OpenDOG sweep, calibration, distillation, soak, terrain and precision
scripts) share: the device and its line, the settled start, a tick replayed
from a CUDA graph on the card, a kernel's record at a path's shape, and the
``metrics.json`` writer.

Importing it puts the repository root on ``sys.path``, so a script run as
``python3 scripts/torch_<name>.py`` from the root imports the port.
"""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def open_device(name=None):
    """(device, line): ``name`` resolved (the card unless the caller names
    another; no card raises), products kept in full float32 (the JAX
    package's ``precision="highest"``), and the card's name and power limit
    as ``nvidia-smi`` gives them, or ``"cpu"``."""
    from opendog_tpu_torch.device import (card_line, resolve_device,
                                          use_full_fp32)
    dev = resolve_device(name)
    use_full_fp32()
    return dev, (card_line() if dev.type == "cuda" else "cpu")


def hold_ctrl(model):
    """The keyframe's control clipped into ctrlrange."""
    import torch
    rng = model.actuator_ctrlrange
    return torch.clamp(model.key_ctrl[0], rng[:, 0], rng[:, 1])


def settled(model, key="home", substeps=150, ctrl=None, terrain=None):
    """The keyframe settled for ``substeps`` substeps of the op-graph step
    under ``ctrl`` (the clipped home control), with zero velocity and the
    clock at 0, as the JAX scripts start their runs."""
    import torch
    from opendog_tpu_torch.physics import State, dynamics, make_state
    s = make_state(model, key)
    if substeps:
        s, _ = dynamics.step(model, s, hold_ctrl(model) if ctrl is None
                             else ctrl, terrain, n_substeps=substeps)
    return State(qpos=s.qpos, qvel=torch.zeros_like(s.qvel),
                 time=torch.zeros((), device=s.qpos.device))


class Replayed:
    """``fn(*tensors) -> tensors``, captured in a CUDA graph at its first
    call and replayed on the card (``solvers.graph.GraphedTick``: the
    counterpart of the JAX scripts' ``jax.jit``), run eagerly elsewhere or
    with ``graphs=False``.  On the card the outputs are the graph's static
    tensors, which the next call overwrites: clone what you keep."""

    def __init__(self, fn, device, graphs=None):
        self.fn, self.device = fn, device
        self.graphs = device.type == "cuda" if graphs is None else graphs
        self.graph = None

    def __call__(self, *inputs):
        if not self.graphs:
            return self.fn(*inputs)
        if self.graph is None:
            from opendog_tpu_torch.solvers.graph import GraphedTick
            self.graph = GraphedTick(self.fn, inputs, self.device)
        return self.graph(*inputs)


def mpc_tick(tick, carry, shape, graphs=None):
    """``tick`` of ``solvers.make_mpc``, or on the card (``graphs`` None or
    True) the tick captured from ``carry`` in a CUDA graph
    (``solvers.graph_tick``; ``shape`` = (K, H, nu), the normals'), which
    computes the same bits."""
    import torch
    dev = carry.plant.qpos.device
    if not (dev.type == "cuda" if graphs is None else graphs):
        return tick
    from opendog_tpu_torch.solvers import graph_tick
    return graph_tick(tick, carry, torch.zeros(shape, device=dev))


def run_ticks(tick, carry, n, normals=None, keys=("qpos",)):
    """``n`` calls of an MPC ``tick`` (``normals`` (n, K, H, nu) injects
    each solve's draw, else the carry's generator draws): the carry and
    the ``keys`` of each tick's info, stacked (copied out of a graph's
    static outputs)."""
    import torch
    outs = {k: [] for k in keys}
    for i in range(n):
        carry, out = tick(carry, None if normals is None else normals[i])
        for k in keys:
            outs[k].append(out[k].clone())
    return carry, {k: torch.stack(v) for k, v in outs.items()}


def kernel_record(label, model, dt, n_substeps, qpos, qvel, ctrl,
                  launches, plane=None, payload=None, reps=20):
    """The ``kernels``-line row of one substep kernel at a path's shape, on
    the path's own (rows, K) inputs on the card: the kernel against its
    plain version (max abs error of qpos and qvel), both timed with CUDA
    events, and its bound (``utils/profiling.substep_bound``).
    ``launches`` is the path's count of this shape
    (``cuda_step.LAUNCHES``)."""
    from opendog_tpu_torch.ops import cuda_step
    from opendog_tpu_torch.utils.profiling import (event_ms, substep_bound,
                                                   substep_row)
    modes = (False if plane is None else plane[0], payload is not None)
    args = [qpos, qvel, ctrl, None if plane is None else plane[1], payload]
    kern = cuda_step.build_cuda_substep(model, dt, n_substeps,
                                        device=qpos.device,
                                        with_plane=modes[0],
                                        with_payload=modes[1])
    plain = cuda_step.build_plain_substep(model, dt, n_substeps, *modes)
    before = cuda_step.LAUNCHES.copy()
    kp, kv = kern(*args)
    pp, pv = plain(*args)
    err = max((kp - pp).abs().max().item(), (kv - pv).abs().max().item())
    ms = event_ms(lambda: kern(*args), reps)
    # the error's call of the plain version was its warm-up
    plain_ms = event_ms(lambda: plain(*args), 1, warm_up=False)
    cuda_step.LAUNCHES.clear()
    cuda_step.LAUNCHES.update(before)
    return substep_row(
        f"{kern.entry} ({label}: K={qpos.shape[1]}, {n_substeps} substeps)",
        launches, err, ms, plain_ms,
        substep_bound(model, dt, n_substeps, modes, args))


def write_metrics(path, res):
    """``res`` as indented JSON at ``path`` (its directory made), and one
    line on stdout."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(res, f, indent=2)
    print(json.dumps(res), flush=True)
