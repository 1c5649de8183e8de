#!/usr/bin/env python3
"""The exact plant kernel on one CUDA card: its row of the kernel table.

Usage, from the root of a checkout, on a machine with a CUDA card:

    python3 scripts/torch_exact_plant.py [--out exact_plant.json]

Builds the kernel library (``opendog_tpu_torch/csrc/``), prints the ptxas
report of ``exact_plant`` (registers, stack, spills) and its launch shape,
then, on OpenDOG's terrain scene (the generated terrain of seed 0) at the
MPC plant's shape, K=1 x 10 substeps of 2 ms:

* the kernel against its plain version on the card (random states on the
  terrain, over the static box and past the grid's edge, K=1 each; the
  widest gap, which must read 0) and against the op-graph step
  ``dynamics.step`` it replaces, from the home keyframe settled on the
  terrain under perturbed controls;
* the milliseconds of one call, by CUDA events: the kernel launched
  eagerly and replayed from a CUDA graph, the plain version, and the
  op-graph step eagerly and replayed from a CUDA graph (as the MPC tick
  replays it), beside the per-geom plane kernel K4 at the same shape;
* its bound: the operations of the plain version
  (``scalar_core.count_substep_ops``) over the card's float32 peak, and the
  bytes it must move (the state in and out, the four heights under every
  sphere at every substep) over its memory rate.

Prints one JSON line (and writes it to ``--out``) with the card's name and
power limit.  It imports no JAX.
"""
import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

K, N_SUB, DT = 1, 10, 0.002
REPS = 200        # eager and replayed kernel calls timed
OPS_REPS = 20     # op-graph step calls timed
SETTLE_TICKS = 25


def card_line():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def graphed(torch, fn, reps):
    """Mean ms of ``fn()`` replayed from a CUDA graph (``reps`` replays),
    captured after one warm-up call on a side stream."""
    from opendog_tpu_torch.utils.profiling import event_ms
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return event_ms(graph.replay, reps)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_exact_plant: no CUDA device is available",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from chip_smoke import EXACT_PLANT_CASES, exact_plant_batch
    from opendog_tpu_torch.assets import load_opendog
    from opendog_tpu_torch.ops import cuda_step, scalar_core
    from opendog_tpu_torch.physics import State, dynamics, make_state
    from opendog_tpu_torch.physics import terrain as terrain_lib
    from opendog_tpu_torch.utils.profiling import CHIP_PEAKS, event_ms

    dev = torch.device("cuda", 0)
    lib, built = cuda_step.cuda_library()
    report = []
    lines = built.log.splitlines()
    for i, line in enumerate(lines):
        if "'exact_plant'" in line:
            report = [ln.strip() for ln in lines[i:i + 4]]
            break
    for line in report:
        print(f"[exact-plant] {line}", file=sys.stderr)
    shape = dict(warps=lib.exact_plant_warps_per_block(),
                 smem_bytes=lib.exact_plant_smem_bytes(),
                 blocks_per_sm=lib.exact_plant_occupancy())

    m = load_opendog("terrain", device=dev)
    terr = terrain_lib.generate_terrain(m, torch.Generator().manual_seed(0))
    terr = terr.to(dev)
    kern = cuda_step.ExactPlant(m, DT, N_SUB, terr.height, dev)
    plain = cuda_step.build_plain_substep(m, DT, N_SUB, scalar_core.TERRAIN)

    # the kernel against its plain version, bit for bit
    plain_gap = 0.0
    for case in EXACT_PLANT_CASES:
        qp, qv, ct, heights = (torch.from_numpy(a).to(dev) for a in
                               exact_plant_batch(m, terr, K, case))
        step = cuda_step.ExactPlant(m, DT, N_SUB, heights, dev)
        kp, kv = step(qp, qv, ct)
        pp, pv = plain(qp, qv, ct, heights)
        plain_gap = max(plain_gap, float((kp - pp).abs().max()),
                        float((kv - pv).abs().max()))

    # a settled stand: the kernel against the op-graph step
    rng = m.actuator_ctrlrange
    hold = torch.clamp(m.key_ctrl[0], rng[:, 0], rng[:, 1])
    h0 = dynamics._terrain_height_normal(m, terr,
                                         torch.zeros(1, 2, device=dev))[0]
    st = make_state(m, "home")
    st = State(qpos=st.qpos.to(dev), qvel=st.qvel.to(dev),
               time=st.time.to(dev))
    st.qpos[2] += h0[0]
    for _ in range(SETTLE_TICKS):
        st = dynamics.step(m, st, hold, terr, n_substeps=N_SUB)[0]
    gen = torch.Generator(device=dev).manual_seed(5)
    gaps = dict(qpos=0.0, qvel=0.0)
    for _ in range(10):
        ctrl = hold + 0.05 * torch.randn(m.nu, device=dev, generator=gen)
        want = dynamics.step(m, st, ctrl, terr, n_substeps=N_SUB)[0]
        kp, kv = kern(st.qpos[:, None], st.qvel[:, None],
                      ctrl[:, None].contiguous())
        gaps["qpos"] = max(gaps["qpos"], float((kp[:, 0] - want.qpos).abs()
                                               .max()))
        gaps["qvel"] = max(gaps["qvel"], float((kv[:, 0] - want.qvel).abs()
                                               .max()))
        st = want

    # times at the plant's shape, from the settled state
    qp = st.qpos[:, None].contiguous()
    qv = st.qvel[:, None].contiguous()
    ct = hold[:, None].contiguous()
    ms = dict(kernel=event_ms(lambda: kern(qp, qv, ct), REPS),
              kernel_graph=graphed(torch, lambda: kern(qp, qv, ct), REPS))
    plain(qp, qv, ct, terr.height)
    ms["plain"] = event_ms(lambda: plain(qp, qv, ct, terr.height), 1,
                           warm_up=False)
    ops_step = lambda: dynamics.step(m, st, hold, terr, n_substeps=N_SUB)
    ms["op_step"] = event_ms(ops_step, OPS_REPS)
    ms["op_step_graph"] = graphed(torch, ops_step, OPS_REPS)
    k4 = cuda_step.build_cuda_substep(m, DT, N_SUB, device=dev,
                                      with_plane="per_geom")
    planes = dynamics.geom_local_planes(m, terr, st.qpos).reshape(-1)[:, None]
    planes = planes.contiguous()
    ms["k4_pergeom"] = event_ms(lambda: k4(qp, qv, ct, plane=planes), REPS)
    cuda_step.LAUNCHES.clear()
    cuda_step.PLANT_LAUNCHES.clear()

    ops = scalar_core.count_substep_ops(m.to("cpu"), DT,
                                        scalar_core.TERRAIN) * K * N_SUB
    nbytes = 4 * (K * (2 * m.nq + 2 * m.nv + m.nu)
                  + 4 * m.ngeom * K * N_SUB)
    peaks = CHIP_PEAKS["h100"]
    t_ops, t_bytes = ops / peaks["fp32_flops"], nbytes / peaks["hbm_bytes"]
    bound_ms = 1e3 * max(t_ops, t_bytes)
    res = dict(kernel=cuda_step.EXACT_PLANT, K=K, n_substeps=N_SUB, dt=DT,
               card=card_line(), ptxas=report, launch=shape,
               max_abs_err_vs_plain=plain_gap, gap_vs_op_step=gaps, ms=ms,
               bound_ms=bound_ms,
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               ops=ops, bytes=nbytes,
               pct_of_bound=100.0 * bound_ms / ms["kernel"])
    line = json.dumps(res)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    if plain_gap != 0.0:
        print(f"torch_exact_plant: the kernel differs from its plain version "
              f"by {plain_gap}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
