#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (opendog_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no "ok" line):
  1. device  - a CUDA card must be present; prints its name and power limit;
  2. build   - builds the substep kernel (csrc/) with nvcc for sm_90a and
               prints the ptxas register / spill report;
  3. check   - the kernel against its plain PyTorch version on the card, on
               random Go1 states, at the main path's two shapes (MPPI rollout:
               K=256, 2 substeps of 10 ms; plant: K=1, 10 substeps of 2 ms);
  4. main    - the Go1 flat-ground MPPI trot loop of bench.py (K=256, H=25,
               2 x 10 ms substeps, plant 10 x 2 ms per 50 Hz tick) through
               make_mpc for 250 ticks from the home keyframe: the trunk stays
               in (0.12, 0.5) m, every state is finite, the robot trots
               forward more than 0.5 m, and the kernel is launched exactly 26
               times per tick (25 rollout steps + 1 plant step);
  5. timing  - CUDA-event times of the kernel and its plain version at both
               shapes, beside the kernel's roofline bound.
The last lines are the card's name and power limit, one JSON object of
kernel records, and {"ok": true, "device": {...}}.
"""
import json
import subprocess
import sys
import time

import numpy as np

TICKS = 250
CHECK_TOL = {"qpos": 1e-4, "qvel": 1e-3}  # kernel vs plain, max abs error
PEAK_FP32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
ROLLOUT = dict(K=256, dt=0.01, n=2)
PLANT = dict(K=1, dt=0.002, n=10)


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def random_batch(model, K, seed=1):
    """Random Go1 states around the home keyframe, as the JAX package's
    tests/test_pallas_core.py::_random_batch builds them: (rows, K)."""
    rng = np.random.default_rng(seed)
    qpos = np.tile(model.numpy("key_qpos")[0], (K, 1)).astype(np.float32)
    qpos[:, :3] += rng.normal(0, 0.01, (K, 3))
    qpos[:, 7:] += rng.normal(0, 0.05, (K, model.nq - 7))
    qvel = rng.normal(0, 0.2, (K, model.nv)).astype(np.float32)
    lo, hi = model.numpy("actuator_ctrlrange").T
    ctrl = rng.uniform(lo, hi, (K, model.nu)).astype(np.float32)
    return tuple(np.ascontiguousarray(a.T) for a in (qpos, qvel, ctrl))


def event_ms(torch, fn, reps):
    """Mean milliseconds of fn() over reps calls, timed with CUDA events
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    import torch

    # ---- 1. device ----
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from opendog_tpu_torch.assets import load_go1
    from opendog_tpu_torch.ops import cuda_step, scalar_core
    from opendog_tpu_torch.physics import make_state
    from opendog_tpu_torch.solvers import MPPIConfig, costs, make_mpc

    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {kind} x{torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 2. build ----
    _, built = cuda_step.cuda_library()
    log(f"[build] {built.path} built in {built.seconds:.1f} s")
    for line in built.log.splitlines():
        if any(w in line for w in ("registers", "spill", "stack", "Compiling")):
            log(f"[build] {line.strip()}")

    # ---- 3. kernel vs plain, on the card ----
    model = load_go1("flat", device=dev)
    records = {}
    for label, shape in (("rollout", ROLLOUT), ("plant", PLANT)):
        qp, qv, ct = (torch.from_numpy(a).to(dev)
                      for a in random_batch(model, shape["K"]))
        kern = cuda_step.build_cuda_substep(model, shape["dt"], shape["n"],
                                            device=dev)
        plain = cuda_step.build_plain_substep(model, shape["dt"], shape["n"])
        kp, kv = kern(qp, qv, ct)
        pp, pv = plain(qp, qv, ct)
        torch.cuda.synchronize()
        err = {"qpos": (kp - pp).abs().max().item(),
               "qvel": (kv - pv).abs().max().item()}
        if not (torch.isfinite(kp).all() and torch.isfinite(kv).all()):
            raise RuntimeError(f"[check] {label}: kernel output not finite")
        # conditioning of these inputs: the plain version's own change when
        # qvel moves by 1e-7 relative (a few float32 ulps)
        _, pv2 = plain(qp, qv * (1 + 1e-7), ct)
        spread = (pv2 - pv).abs().max(dim=0).values
        log(f"[check] {label} K={shape['K']} x{shape['n']} dt={shape['dt']}: "
            f"max abs err qpos {err['qpos']:.3e} qvel {err['qvel']:.3e} "
            f"(tolerance {CHECK_TOL['qpos']:.0e} / {CHECK_TOL['qvel']:.0e}; "
            f"max |qvel| {pv.abs().max().item():.3f}; plain qvel moves by "
            f"up to {spread.max().item():.3e} under a 1e-7 relative change "
            f"of qvel, by > 1e-4 in {int((spread > 1e-4).sum())} of "
            f"{shape['K']} rollouts)")
        for k in err:
            if not err[k] <= CHECK_TOL[k]:
                raise RuntimeError(f"[check] {label}: kernel disagrees with "
                                   f"its plain version on {k}: {err[k]}")
        records[label] = dict(shape=shape, err=max(err.values()),
                              args=(qp, qv, ct), kern=kern, plain=plain)

    # ---- 4. main path: the bench.py trot loop through make_mpc ----
    params = costs.TrotCostParams(desired_vel_xy=(0.5, 0.0),
                                  target_height=0.265)
    cost = costs.trot_cost(model, params, model.key_qpos[0, 7:], legs="go1")
    cfg = MPPIConfig(horizon=25, num_samples=256, n_substeps=2,
                     rollout_dt=0.01, noise_sigma=0.12, temperature=0.3)
    init, tick, _ = make_mpc(model, cost, cfg, plant_substeps=10,
                             device=dev)
    warm = init(torch.Generator(device=dev).manual_seed(1),
                make_state(model, "home"))
    for _ in range(3):
        warm, _ = tick(warm)
    torch.cuda.synchronize()

    carry = init(torch.Generator(device=dev).manual_seed(0),
                 make_state(model, "home"))
    cuda_step.LAUNCHES.clear()
    t0 = time.perf_counter()
    zs, finite = [], []
    for _ in range(TICKS):
        carry, out = tick(carry)
        zs.append(out["qpos"][2])
        finite.append(torch.isfinite(out["qpos"]).all()
                      & torch.isfinite(out["qvel"]).all())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda_step.LAUNCHES)
    z = torch.stack(zs).cpu().numpy()
    all_finite = bool(torch.stack(finite).all().item())
    final_x = float(carry.plant.qpos[0].item())
    ms_tick = 1e3 * wall / TICKS
    log(f"[main] {TICKS} ticks in {wall:.3f} s: {ms_tick:.3f} ms/tick, "
        f"{TICKS / wall:.2f} solves/s | final_x {final_x:.3f} m | trunk z "
        f"min {z.min():.4f} max {z.max():.4f} | finite {all_finite} | "
        f"best_cost {float(out['best_cost']):.3f} ess {float(out['ess']):.2f}")
    log(f"[main] kernel launches: {launches}")
    key_r = cuda_step.launch_key(ROLLOUT["K"], ROLLOUT["n"])
    key_p = cuda_step.launch_key(PLANT["K"], PLANT["n"])
    want = {key_r: cfg.horizon * TICKS, key_p: TICKS}
    if launches != want:
        raise RuntimeError(f"[main] kernel launches {launches} != {want} "
                           f"(26 per tick)")
    if not ((z > 0.12) & (z < 0.5)).all():
        raise RuntimeError("[main] trunk height left (0.12, 0.5) m")
    if not all_finite:
        raise RuntimeError("[main] non-finite plant state")
    if not final_x > 0.5:
        raise RuntimeError(f"[main] final_x {final_x:.3f} m <= 0.5 m")
    records["rollout"]["launches"] = launches[key_r]
    records["plant"]["launches"] = launches[key_p]

    # device busy share over a short window of ticks (profiler trace)
    busy = "not measured"
    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(10):
                carry, out = tick(carry)
            torch.cuda.synchronize()
            window_us = 1e6 * (time.perf_counter() - t0)
        dev_us, kern_us, rows = 0.0, 0.0, []
        for ev in prof.key_averages():
            if ev.device_type != DeviceType.CUDA:
                continue  # host-side events; their kernels are listed too
            t = getattr(ev, "self_device_time_total",
                        getattr(ev, "self_cuda_time_total", 0.0))
            dev_us += t
            if "substep_kernel" in ev.key:
                kern_us += t
            rows.append((t, ev.count, ev.key))
        if dev_us > 0:
            busy = (f"{100 * dev_us / window_us:.1f}% busy, substep kernel "
                    f"{100 * kern_us / window_us:.1f}% of {window_us / 10:.0f} "
                    f"us/tick, {sum(r[1] for r in rows) / 10:.0f} kernel "
                    f"launches/tick")
        for t, count, key in sorted(rows, reverse=True)[:8]:
            log(f"[profile] {t / 10:10.1f} us/tick  {count / 10:7.1f} "
                f"calls/tick  {key[:70]}")
    except (RuntimeError, AttributeError) as e:
        busy = f"not measured ({type(e).__name__}: {e})"
    log(f"[profile] device over 10 ticks: {busy}")

    # ---- 5. kernel timing ----
    kernels = []
    for label, rec in records.items():
        shape = rec["shape"]
        K, n = shape["K"], shape["n"]
        args = rec["args"]
        ms = event_ms(torch, lambda: rec["kern"](*args),
                      200 if label == "rollout" else 500)
        plain_ms = event_ms(torch, lambda: rec["plain"](*args), 2)
        ops = scalar_core.count_substep_ops(model, shape["dt"]) * K * n
        nbytes = 4 * K * (2 * model.nq + 2 * model.nv + model.nu)
        t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
        bound_ms = 1e3 * max(t_ops, t_bytes)
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        log(f"[timing] {label} K={K} x{n}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.2f} ms, bound {bound_ms:.6f} ms by {bound_by} "
            f"({ops} ops at 67 TFLOP/s fp32 vs {nbytes} B at 3.35 TB/s; "
            f"{100 * bound_ms / ms:.3f}% of bound); library call: none "
            f"computes this function")
        kernels.append({
            "name": f"{cuda_step.KERNEL_NAME} ({label}: K={K}, {n} substeps)",
            "route": "cuda",
            "source": "opendog_tpu_torch/csrc/substep_kernel.cu",
            "replaces": "opendog_tpu/ops/pallas_step.py:115",
            "launches": rec["launches"],
            "max_abs_err": rec["err"],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
        })

    # ---- 6. summary ----
    log(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
