#!/usr/bin/env python3
"""Time the substep kernels (K1 ``substep_flat``, K2 ``substep_payload``,
K3 ``substep_plane``, K4 ``substep_pergeom``, K2 + K4
``substep_pergeom_payload``, K2 + K3 ``substep_plane_payload``) at W = 1, 2,
4 and 8 rollouts per block on one CUDA card.

Usage, from the root of a checkout:  python3 scripts/torch_warp_sweep.py

W is the compile-time constant SC_WARPS of csrc/substep_kernel.cu, and
SC_WARPS_SMALL that of the batch's small workspace class.  The script builds
the kernel library once per W with ``-DSC_WARPS=W -DSC_WARPS_SMALL=W`` (the
build flags of ops/build.py, one nvcc process per W, all at once, into a
temporary directory), then launches each build's kernels at their paths'
shapes and times them with CUDA events, the builds in the order 1, 2, 4, 8,
8, 4, 2, 1:
  K1, K2  random Go1 states (``chip_smoke.random_batch``; K2 with the
          payloads U(0, 3) kg of ``chip_smoke.random_modes``) at the flat
          MPC path's MPPI rollout (K=256 x 2 substeps of 10 ms) and plant
          (K=1 x 10 of 2 ms);
  K3      random OpenDOG states on the ground with random planes at the
          trunk-plane MPPI rollout (K=256 x 2);
  K4      random OpenDOG states on the generated terrain (seed 0) with their
          own per-geom planes (``chip_smoke.terrain_batch``) at the per-geom
          MPPI rollout (K=256 x 2) and the terrain plant (K=1 x 10);
  K2+K4   the same states and planes with payloads U(0, 3) kg at the
          per-geom payload MPPI rollout (K=256 x 2);
  K2+K3   the domain-randomised batch (``chip_smoke.batch_inputs``, K=4096
          x 10 substeps of 2 ms) in both workspace size classes: "small"
          (the kernel the launcher picks for OpenDOG's 24 spheres) and
          "full" (forced by passing the launcher SC_NG_MAX spheres).
It prints one JSON line with each build's times, and each kernel's dynamic
shared memory per block and blocks resident per SM at every W, whether
every build's and class's output equals the W=1 build's bit for bit (exit
code 1 if not), and, per robot, the serial work of the busiest lane in the
two contact phases of the warp design (``lane_loads``).  It imports no JAX.
"""
import json
import os
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import (batch_inputs, nvidia_smi_line,  # noqa: E402
                        random_batch, random_modes, terrain_batch)
from opendog_tpu_torch.assets import load_go1, load_opendog  # noqa: E402
from opendog_tpu_torch.ops import build, cuda_step  # noqa: E402
from opendog_tpu_torch.physics import terrain as terrain_lib  # noqa: E402
from opendog_tpu_torch.utils.profiling import event_ms  # noqa: E402

WARPS = (1, 2, 4, 8)
ROLLOUT, PLANT = (256, 0.01, 2), (1, 0.002, 10)
BATCH = (4096, 0.002, 10)
KERNELS = (  # name, robot, with_plane, with_payload, shapes
    ("substep_flat", "go1", False, False, (ROLLOUT, PLANT)),
    ("substep_payload", "go1", False, True, (ROLLOUT, PLANT)),
    ("substep_plane", "opendog", True, False, (ROLLOUT,)),
    ("substep_pergeom", "opendog", "per_geom", False, (ROLLOUT, PLANT)),
    ("substep_pergeom_payload", "opendog", "per_geom", True, (ROLLOUT,)),
    ("substep_plane_payload", "opendog_flat", True, True, (BATCH,)),
)
REPS = 200


def lane_loads(model):
    """The busiest lane's serial work in the contact phases of
    csrc/substep_warp.cuh, with the kernel's lane assignment: in scw_dof_geom
    lane l makes the J rows of spheres l, l + 32, ...; in scw_pair it sums
    the sphere terms of D for pairs l, l + 32, ... and the contact terms of
    qfrc for dof 31 - l.  Counts of J rows and of sphere terms, from the
    model table."""
    t = cuda_step.substep_table(model, model.timestep)
    nj = [t.dof_nsph[t.pair_j[p]] for p in range(t.npair)]
    rows = [sum(t.body_ndof[t.geom_body[g]] for g in range(lane, t.ng, 32))
            for lane in range(32)]
    terms = [sum(nj[lane::32])
             + (t.dof_nsph[31 - lane] if 31 - lane < t.nv else 0)
             for lane in range(32)]
    busiest = max(range(32), key=terms.__getitem__)
    return {"j_rows": {"busiest_lane": max(rows), "total": sum(rows)},
            "sphere_terms": {"busiest_lane": terms[busiest],
                             "lane": busiest, "total": sum(terms),
                             "longest_single_sum": max(nj)}}


def build_all(tmp):
    """One library per W, built by concurrent nvcc processes."""
    nvcc, src = build.find_nvcc(), os.path.join(build.CSRC, "substep_kernel.cu")
    procs = {w: subprocess.Popen(
        [nvcc, *build.NVCC_FLAGS, f"-DSC_WARPS={w}",
         f"-DSC_WARPS_SMALL={w}", "-o",
         os.path.join(tmp, f"libsubstep_w{w}.so"), src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=build.CSRC) for w in WARPS}
    libs = {}
    for w, p in procs.items():
        out, _ = p.communicate(timeout=600)
        if p.returncode != 0:
            raise RuntimeError(f"nvcc -DSC_WARPS={w} failed:\n{out}")
        libs[w] = cuda_step.load_library(os.path.join(tmp, f"libsubstep_w{w}.so"))
        got = libs[w].substep_warps_per_block(0, 0, 0)
        if got != w:
            raise RuntimeError(f"the W={w} build reports {got}")
    return libs


def launcher(lib, table, args, n, with_plane, with_payload, ngeom):
    """fn() launching the kernel of the mode of ``lib`` for a model of
    ``ngeom`` spheres once on ``args`` (qpos, qvel, ctrl, plane or None,
    payload or None)."""
    qp, qv, ct, plane, payload = args
    out_p, out_v = torch.empty_like(qp), torch.empty_like(qv)
    ptr = lambda x: None if x is None else x.data_ptr()

    def fn():
        rc = lib.substep_launch(
            table.data_ptr(), qp.data_ptr(), qv.data_ptr(), ct.data_ptr(),
            ptr(plane), ptr(payload), out_p.data_ptr(), out_v.data_ptr(),
            qp.shape[1], n, cuda_step._PLANE_CODE[with_plane],
            int(with_payload), ngeom, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return out_p, out_v

    return fn


def inputs(model, terr, K, with_plane, with_payload):
    """The kernel's inputs at K rollouts, numpy (rows, K) or None."""
    if with_plane and with_payload:
        if with_plane == "per_geom":
            return terrain_batch(model, terr, K) + random_modes(
                model, K, False, True)[1:]
        return batch_inputs(model, K)
    if with_plane == "per_geom":
        return terrain_batch(model, terr, K) + (None,)
    if with_plane:
        return random_batch(model, K, on_ground=True) + random_modes(
            model, K, True)
    arrays = random_batch(model, K) + random_modes(model, K, False, True)
    return arrays if with_payload else arrays[:3] + (None, None)


def main() -> int:
    dev = torch.device("cuda", 0)
    models = {"go1": load_go1("flat", device=dev),
              "opendog": load_opendog("terrain", device=dev),
              "opendog_flat": load_opendog("flat", device=dev)}
    terr = terrain_lib.generate_terrain(models["opendog"],
                                        torch.Generator().manual_seed(0))
    n_max = cuda_step.table_layout()[0]["SC_NG_MAX"]
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_all(tmp)
        ok, results, shapes_of = True, [], {}
        for name, robot, with_plane, with_payload, shapes in KERNELS:
            model = models[robot]
            # size classes: the one the launcher picks, and for the batch
            # also the full one
            classes = {"path": model.ngeom}
            if with_plane is True and with_payload:
                classes = {"small": model.ngeom, "full": n_max}
            mode = (cuda_step._PLANE_CODE[with_plane], int(with_payload))
            for cls, ngeom in classes.items():
                shapes_of[f"{name}/{cls}"] = {str(w): {
                    "smem_bytes": libs[w].substep_warp_smem_bytes(*mode, ngeom),
                    "blocks_per_sm": libs[w].substep_warp_occupancy(*mode,
                                                                    ngeom)}
                    for w in WARPS}
            for K, dt, n in shapes:
                args = [None if a is None else torch.from_numpy(a).to(dev)
                        for a in inputs(model, terr, K, with_plane,
                                        with_payload)]
                raw = bytearray(memoryview(cuda_step.substep_table(model, dt))
                                .cast("B"))
                table = torch.frombuffer(raw, dtype=torch.uint8).to(dev)
                runs = [(w, cls) for w in WARPS for cls in classes]
                fns = {(w, cls): launcher(libs[w], table, args, n, with_plane,
                                          with_payload, classes[cls])
                       for w, cls in runs}
                outs = {r: [t.clone() for t in fns[r]()] for r in runs}
                torch.cuda.synchronize()
                same = all(torch.equal(outs[r][i], outs[runs[0]][i])
                           for r in runs for i in range(2))
                ms = {r: [] for r in runs}
                for r in runs + runs[::-1]:
                    ms[r].append(event_ms(fns[r], REPS))
                ok = ok and same
                results.append({"kernel": name, "shape": f"K={K} x{n}",
                                "bit_identical_across_W": same,
                                "ms": {f"{w}/{cls}": ms[(w, cls)]
                                       for w, cls in runs}})
    print(json.dumps({"card": nvidia_smi_line(), "reps": REPS,
                      "launch_shapes": shapes_of,
                      "lane_loads": {robot: lane_loads(m.to("cpu"))
                                     for robot, m in models.items()},
                      "results": results}),
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
