#!/usr/bin/env python3
"""The per-geom plane kernel (K4, ``substep_pergeom``) on one CUDA card at
the shapes of the per-geom terrain MPC at 4096 rollouts: its rows of the
kernel table.

Usage, from the root of a checkout, on a machine with a CUDA card:

    python3 scripts/torch_pergeom_kernel.py [--out pergeom_kernel.json]

On OpenDOG's terrain scene (the generated terrain of seed 0), from the home
keyframe lifted onto the ground with its joints perturbed by N(0, 0.03) rad
in every lane, each lane's planes built under its own spheres
(``dynamics.geom_local_planes``), at two shapes: the rollouts' K=4096 x 2
substeps of 10 ms and the plant's K=1 x 10 substeps of 2 ms.  Each row
(``scripts/torch_app_common.py::kernel_record``): the kernel against its
plain version on the card (the widest gap, which must read 0), the
milliseconds of one call by CUDA events, the plain version's, and the bound
(``utils/profiling.substep_bound``).  Also the kernel's ptxas report and
launch shape.  Prints one JSON line (and writes it to ``--out``) with the
card's name and power limit.  It imports no JAX.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# (label, K, substeps, dt, launches a tick of the benchmark's cell)
SHAPES = (("rollout", 4096, 2, 0.01, 25), ("plant", 1, 10, 0.002, 1))
SIGMA = 0.03


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_pergeom_kernel: no CUDA device is available",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from torch_app_common import kernel_record
    from torch_exact_plant import card_line
    from opendog_tpu_torch.assets import load_opendog
    from opendog_tpu_torch.ops import cuda_step
    from opendog_tpu_torch.physics import dynamics
    from opendog_tpu_torch.physics import terrain as terrain_lib

    dev = torch.device("cuda", 0)
    lib, built = cuda_step.cuda_library()
    lines = built.log.splitlines()
    report = next(([ln.strip() for ln in lines[i:i + 4]]
                   for i, line in enumerate(lines)
                   if "'substep_pergeom'" in line), [])
    for line in report:
        print(f"[pergeom] {line}", file=sys.stderr)
    shape = dict(warps=lib.substep_warps_per_block(2, 0, 24),
                 smem_bytes=lib.substep_warp_smem_bytes(2, 0, 24),
                 blocks_per_sm=lib.substep_warp_occupancy(2, 0, 24))

    m = load_opendog("terrain", device=dev)
    terr = terrain_lib.generate_terrain(
        m, torch.Generator().manual_seed(0)).to(dev)
    h0 = dynamics._terrain_height_normal(m, terr,
                                         torch.zeros(1, 2, device=dev))[0]
    rng = m.actuator_ctrlrange
    hold = torch.clamp(m.key_ctrl[0], rng[:, 0], rng[:, 1])
    gen = torch.Generator(device=dev).manual_seed(7)
    rows = []
    for label, K, n, dt, launches in SHAPES:
        qpos = m.key_qpos[0][None].repeat(K, 1)
        qpos[:, 2] += h0[0]
        qpos[:, 7:] += SIGMA * torch.randn(K, m.nq - 7, device=dev,
                                           generator=gen)
        planes = dynamics.geom_local_planes(m, terr, qpos).reshape(K, -1)
        rec = kernel_record(
            label, m, dt, n, qpos.T.contiguous(),
            torch.zeros(m.nv, K, device=dev),
            hold[:, None].expand(-1, K).contiguous(), launches,
            plane=("per_geom", planes.T.contiguous()))
        rows.append(rec)
        print(f"[pergeom] {rec['name']}: {rec['ms']:.4f} ms, plain "
              f"{rec['plain_ms']:.1f} ms, bound {rec['bound_ms']:.6f} ms, "
              f"gap {rec['max_abs_err']}", file=sys.stderr)
    cuda_step.LAUNCHES.clear()
    res = dict(kernel="substep_pergeom", card=card_line(), ptxas=report,
               launch=shape, rows=rows)
    line = json.dumps(res)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    gap = max(r["max_abs_err"] for r in rows)
    if gap != 0.0:
        print(f"torch_pergeom_kernel: the kernel differs from its plain "
              f"version by {gap}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
