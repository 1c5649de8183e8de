#!/usr/bin/env python
"""Full-stack sim2real rehearsal of the command student on the port:
drives runs/distill_cmd_opendog/student.msgpack (read without flax) through
the deployment path — SDK → C++ firmware_sim (UDP/JSON + ACK, 500 Hz PID
servo plant) → telemetry-measured angles → DigitalTwin body-state estimate
→ next policy tick — with live command switching.  The counterpart of the
JAX package's scripts/cmd_student_bridge.py: the same schedule, arms and
summary.

Two arms:
  * 50 Hz — the student's training tick rate;
  * 12.5 Hz — the reference robot's achieved on-hardware rate
    (run_robot.py:37), zero-order-holding the gait between commands.

The student and the twin run on the card unless ``--device cpu``.  Writes
``<out>/metrics.json`` (default runs/torch_cmd_student_bridge/, listed in
.gitignore): per-segment command tracking (heading-frame speed + wrapped
yaw error on the twin), joint RMSE over the wire, host-loop timing.

    python3 scripts/torch_cmd_student_bridge.py --smoke
"""
import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def schedule(T):
    """The live command schedule, ``T`` ticks per unit: stand -> slow trot
    -> nominal trot -> trot+turn left -> trot+turn right -> turn in place
    -> stand."""
    return [
        ([0.0, 0.0, 0.0], T),
        ([0.1, 0.0, 0.0], 2 * T),
        ([0.17, 0.0, 0.0], 2 * T),
        ([0.15, 0.0, 0.3], 2 * T),
        ([0.15, 0.0, -0.3], 2 * T),
        ([0.0, 0.0, 0.2], 2 * T),
        ([0.0, 0.0, 0.0], T),
    ]


def summary(segments):
    """The 50 Hz arm's booleans: every segment upright, the stand segment
    holds, the student walks on every forward command and turns on every
    yaw command."""
    moving = [s for s in segments if s["cmd"][0] > 0]
    return dict(
        upright_all=bool(all(s["z_min"] > 0.035 for s in segments)),
        stand_holds=bool(abs(segments[0]["mean_vx_cmd_frame"]) < 0.03),
        walks_on_command=bool(all(s["mean_vx_cmd_frame"] > 0.03
                                  for s in moving)),
        turns_on_command=bool(all(
            s["yaw_err"] < 0.25 for s in segments if s["cmd"][2] != 0.0)),
    )


def wait_for_telemetry(body, seconds=3.0):
    deadline = time.time() + seconds
    while time.time() < deadline:
        if (body.is_data_available_from_esp(0)
                and body.is_data_available_from_esp(1)):
            return
        time.sleep(0.05)
    raise RuntimeError("no telemetry from firmware sims")


def run(student_dir, listen_port, T, rates, device=None, log=print):
    """Both arms (``rates``) of the schedule at ``T`` against two firmware
    simulators spawned on loopback (terminated on the way out).  Returns
    the metrics dict: one entry per arm and the 50 Hz arm's summary."""
    from opendog_tpu_torch.apps.mpc_bridge import StudentBridge
    from opendog_tpu_torch.native import build as native
    from opendog_tpu_torch.rl.distill_zoo import (cmd_distill_setup,
                                                  load_student)
    from opendog_tpu_torch.sdk import QuadPilotBody

    p1, p2 = listen_port + 1, listen_port + 2
    with native.firmware_pair(p1, p2, listen_port):
        setup = cmd_distill_setup("opendog", engine="kernel", device=device)
        policy = load_student(os.path.join(student_dir, "student.msgpack"),
                              setup, command_dim=3)
        body = QuadPilotBody(ip1="127.0.0.1", ip2="127.0.0.1",
                             port1=p1, port2=p2,
                             listen_for_broadcasts=True,
                             listen_port=listen_port)
        try:
            bridge = StudentBridge(setup.model, policy, body,
                                   device=setup.model.device)
            if not bridge.bring_up(settle_s=1.0):
                raise RuntimeError("bring-up not ACKed")
            wait_for_telemetry(body)
            # warm the policy and the twin's graph outside the paced window
            for _ in range(10):
                bridge.tick()
                time.sleep(0.02)
            res = {"student": os.path.relpath(student_dir, REPO),
                   "device": str(bridge.device),
                   "recipe_fingerprint": setup.recipe["cost_params"]
                   ["amp_knots"]}
            for rate in rates:
                out = bridge.run_segments(schedule(T), rate_hz=rate)
                key = f"rate_{rate:g}hz"
                res[key] = out
                log(f"{key} " + json.dumps(
                    {k: v for k, v in out.items() if k != "segments"}))
                for s in out["segments"]:
                    log("   " + json.dumps(s))
                # settle back to stand between arms
                bridge.set_command([0.0, 0.0, 0.0])
                for _ in range(20):
                    bridge.tick()
                    time.sleep(0.02)
        finally:
            body.close()
    res["summary"] = summary(res["rate_50hz"]["segments"])
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="runs/torch_cmd_student_bridge")
    ap.add_argument("--student", default="runs/distill_cmd_opendog")
    ap.add_argument("--listen_port", type=int, default=19845)
    ap.add_argument("--seg_ticks", type=int, default=150)
    ap.add_argument("--smoke", action="store_true",
                   help="10 ticks per schedule unit, the 50 Hz arm only")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    T = 10 if args.smoke else args.seg_ticks
    rates = (50.0,) if args.smoke else (50.0, 12.5)
    res = run(os.path.join(REPO, args.student), args.listen_port, T, rates,
              device=args.device, log=lambda s: print(s, flush=True))
    out = os.path.join(REPO, args.out)
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "metrics.json"), "w") as f:
        json.dump(res, f, indent=2)
    print(json.dumps(res["summary"]), flush=True)


if __name__ == "__main__":
    main()
