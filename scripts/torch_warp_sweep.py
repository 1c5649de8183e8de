#!/usr/bin/env python3
"""Time the warp-design substep kernels (K1 ``substep_flat``, K2
``substep_payload``) at W = 1, 2 and 4 rollouts per block on one CUDA card.

Usage, from the root of a checkout:  python3 scripts/torch_warp_sweep.py

W is the compile-time constant SC_WARPS of csrc/substep_kernel.cu.  The
script builds the kernel library three times with ``-DSC_WARPS=W`` (the
build flags of ops/build.py, three nvcc processes at once, into a temporary
directory), then launches each build's K1 and K2 on the random Go1 states of
``chip_smoke.random_batch`` (payloads U(0, 3) kg from
``chip_smoke.random_modes``) at the flat MPC path's two shapes (MPPI
rollout K=256 x 2 substeps of 10 ms, plant K=1 x 10 of 2 ms) and times them
with CUDA events, the builds in the order 1, 2, 4, 4, 2, 1.  It prints one
JSON line with each build's times and dynamic shared memory per block,
whether every build's output equals the W=1 build's bit for bit (exit code 1
if not), and the serial work of the busiest lane in the two contact phases
of the warp design (``lane_loads``).  It imports no JAX.
"""
import json
import os
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import event_ms, nvidia_smi_line, random_batch, random_modes  # noqa: E402
from opendog_tpu_torch.assets import load_go1  # noqa: E402
from opendog_tpu_torch.ops import build, cuda_step  # noqa: E402

WARPS = (1, 2, 4)
SHAPES = ((256, 0.01, 2), (1, 0.002, 10))
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
        [nvcc, *build.NVCC_FLAGS, f"-DSC_WARPS={w}", "-o",
         os.path.join(tmp, f"libsubstep_w{w}.so"), src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=build.CSRC) for w in WARPS}
    libs = {}
    for w, p in procs.items():
        out, _ = p.communicate(timeout=600)
        if p.returncode != 0:
            raise RuntimeError(f"nvcc -DSC_WARPS={w} failed:\n{out}")
        libs[w] = cuda_step.load_library(os.path.join(tmp, f"libsubstep_w{w}.so"))
        if libs[w].substep_warps_per_block() != w:
            raise RuntimeError(f"the W={w} build reports "
                               f"{libs[w].substep_warps_per_block()}")
    return libs


def launcher(lib, table, args, n, with_payload):
    """fn() launching the flat kernel of ``lib`` once on ``args``."""
    qp, qv, ct, payload = args
    out_p, out_v = torch.empty_like(qp), torch.empty_like(qv)

    def fn():
        rc = lib.substep_launch(
            table.data_ptr(), qp.data_ptr(), qv.data_ptr(), ct.data_ptr(),
            None, payload.data_ptr() if with_payload else None,
            out_p.data_ptr(), out_v.data_ptr(), qp.shape[1], n, 0,
            int(with_payload), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return out_p, out_v

    return fn


def main() -> int:
    dev = torch.device("cuda", 0)
    model = load_go1("flat", device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_all(tmp)
        ok, results = True, []
        for name, with_payload in (("substep_flat", False),
                                   ("substep_payload", True)):
            for K, dt, n in SHAPES:
                arrays = random_batch(model, K) + random_modes(
                    model, K, False, True)[1:]
                args = [torch.from_numpy(a).to(dev) for a in arrays]
                raw = bytearray(memoryview(cuda_step.substep_table(model, dt))
                                .cast("B"))
                table = torch.frombuffer(raw, dtype=torch.uint8).to(dev)
                fns = {w: launcher(libs[w], table, args, n, with_payload)
                       for w in WARPS}
                outs = {w: [t.clone() for t in fns[w]()] for w in WARPS}
                torch.cuda.synchronize()
                same = all(torch.equal(outs[w][i], outs[1][i])
                           for w in WARPS for i in range(2))
                ms = {w: [] for w in WARPS}
                for w in WARPS + WARPS[::-1]:
                    ms[w].append(event_ms(torch, fns[w], REPS))
                ok = ok and same
                results.append({"kernel": name, "shape": f"K={K} x{n}",
                                "bit_identical_across_W": same,
                                "ms": {str(w): ms[w] for w in WARPS}})
        smem = {str(w): libs[w].substep_warp_smem_bytes() for w in WARPS}
    print(json.dumps({"card": nvidia_smi_line(), "reps": REPS,
                      "smem_bytes_per_block": smem,
                      "lane_loads_go1": lane_loads(model.to("cpu")),
                      "results": results}),
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
