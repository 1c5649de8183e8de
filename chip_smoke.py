#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (opendog_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no "ok" line):
  device   - a CUDA card must be present; prints its name and power limit;
  build    - builds the substep kernels (csrc/, one nvcc call: the six
             entry points flat, payload, plane, pergeom, plane_payload and
             pergeom_payload, all one warp per rollout, and the batch's
             plane_payload kernel for models of at most 32 spheres, the
             exact plant, exact_plant, and the rollouts' tracking cost,
             rollout_tracking_cost) for
             sm_90a and prints the ptxas report of each and, for each entry
             point at its paths' model, the rollouts and dynamic shared
             memory per block and the blocks and warps resident per SM;
  check    - every kernel against its plain PyTorch version on the card at
             every shape its paths launch: flat on random Go1 states (MPPI
             rollout K=256 x 2 substeps of 10 ms; plant K=1 x 10 of 2 ms);
             payload on random Go1 states with payloads U(0, 3) kg (K=256
             x 2); plane on random OpenDOG states with random planes (K=256
             x 2); pergeom on random OpenDOG states on the generated terrain
             with their own per-geom planes (K=256 x 2, K=1 x 10);
             plane_payload on the domain-randomised batch (K=4096 x 10);
             pergeom_payload on the terrain states with payloads U(0, 3) kg
             (K=256 x 2); flat at the robot bridge's OpenDOG shapes (MPPI
             rollout K=256 x 2, compensated predictor K=1 x 10); flat at
             the multi-device phases' one-process reference (Go1 K=512 x
             2) and the multi-process MPPI's OpenDOG K=64 x 2 per rank; flat
             and payload at the distiller's shapes (Go1
             expert K=4096 x 2, plant K=8 x 10; OpenDOG bench 5 expert
             K=512 x 2); flat and plane_payload at the benchmark suite's
             batches (scripts/torch_bench_suite.py: config 4b, OpenDOG
             K=4096 x 10 of 2 ms from config 4's start; config 4d,
             K=32,768 x 10 on its domain-randomised batch, the 32-sphere
             build); the exact plant (exact_plant: the heightfield and the
             static box at every substep) at its K=1 x 10 on random OpenDOG
             states on the terrain, over the box and past the grid's edge,
             equal to its plain version; and, check only, all six at a
             ragged K=257 x 2 and flat at bench 5's OpenDOG plant K=8 x 10;
             the tracking-cost kernel (rollout_tracking_cost) against the
             op path it replaces (standing_cost's closure on the carry,
             times the discount, added up) over 25 control steps of the
             substep kernel, every step's cost and the total bit for bit,
             at the lane counts its paths launch (256 after K3 and after K4
             on the terrain, bench 5's expert 8 x 64 on OpenDOG flat) and,
             check only, [multidev]'s 64 a rank, the benchmark's per-geom
             4096, Go1 (12 controls) at 256 and a ragged 257;
  main     - the Go1 flat-ground MPPI trot loop of bench.py (K=256, H=25,
             2 x 10 ms substeps, plant 10 x 2 ms per 50 Hz tick) through
             make_mpc: the tick captured in a CUDA graph (graph_tick) must
             equal the eager tick bit for bit on the same injected normals
             for 4 ticks (ctrl, qpos, qvel, nominal); then 150 ticks eager
             and 150 replayed (250 before the PPO phases), each from generator seed 0: trunk in (0.12,
             0.5) m, finite, forward more than 0.5 m, 25 + 1 flat launches
             per tick (counted per replay on the graph) and no launch of
             the tracking-cost kernel (the trot cost runs its torch ops),
             ms/tick of both side by side;
  terrain  - OpenDOG terrain MPC with per-geom planes on both sides (bench
             2c_pergeom: K=256, H=25, 2 x 10 ms, sigma 0.08; per-geom
             kernel plant) on a generated terrain, eager and graph as in
             main, 50 ticks each (100 before the PPO phases): finite,
             trunk above the ground under it
             in (0.03, 0.21) m at every tick and in (0.03, 0.15) m once the
             drop from the keyframe is over, 25 + 1 pergeom launches per
             tick and 25 of the tracking-cost kernel (COST_LAUNCHES, L=256;
             per replay on the graph too);
  terrain-trunk - the same with one trunk plane for the rollouts, 50 ticks,
             25 plane + 1 pergeom launches and 25 cost launches per tick;
  ops-check - the op-graph physics step (dynamics.step) on the card against
             the flat kernel on random Go1 states (K=256, one 2 ms substep;
             the cross-engine tolerance 1e-4 qpos, 5e-3 qvel) and against
             the same step on the CPU on the same inputs (1e-4 qpos, 1e-3
             qvel);
  exact-terrain - bench 2c: the terrain loop with one trunk plane for the
             rollouts and the default exact plant (the exact plant kernel:
             the contact of the op-graph step, bilinear heightfield and
             static box, 10 x 2 ms), eager and graph as in main, as
             many ticks as terrain, the height bands of terrain, 25 plane
             launches, 25 cost launches and one exact plant launch
             (PLANT_LAUNCHES) per tick of the graph; then terrain's deviation
             check: final_dev_vs_exact_plant_m, the distance between the
             trunk positions that the per-geom kernel-plant loop and this
             loop reach from the same start on the same normals in as many
             ticks (bench 2c_pergeom's honesty check, printed, not gated);
  ops-engine - op-graph MPPI (engine="ops") of Go1 standing on the jump
             scene's box (box contact), K=256, H=25, 2 x 10 ms: the graphed
             solve equals the eager one bit for bit on injected normals for
             2 solves; 2 solves eager and 2 replayed (5 before the bridge phases,
             3 before the multi-device phases), every
             output finite,
             no substep kernel launched;
  payload  - payload-aware trot MPPI (bench 2d): 0 kg equals the flat
             solver to 1e-6, 1.5 kg changes best_cost; the solve captured
             in a CUDA graph (graph_solve) equals the eager solve bit for
             bit on injected normals (ctrl, nominal, stats); 100 solves
             with 1.5 kg eager and 100 replayed: finite, 25 payload
             launches per solve;
  batch    - 20 steps of the K=4096 domain-randomised plane + payload batch
             (bench 4c): finite;
  pergeom-payload - per-geom terrain solves of OpenDOG standing on the
             generated terrain with 0.5 kg: 0 kg equals the per-geom solver
             to 1e-6, 0.5 kg changes best_cost; graph vs eager as in
             payload; 10 solves each: finite, 25 pergeom_payload launches
             and 25 cost launches per solve;
  ilqr     - bench 3 (scripts/bench_suite.py:305-326) at full width: Go1
             flat, standing_cost(0.265), whole-body iLQR (make_ilqr_tracker:
             horizon 50, 2 x 10 ms substeps, 3 iterations; 50 tracked ticks
             of 10 x 2 ms) from the home state settled for 200 substeps;
             a capture cycle, then ILQR_CYCLES timed cycles with every
             piece of the solve and the tracked tick replayed from its CUDA
             graph, then one eager cycle from the first timed cycle's start,
             which must equal it bit for bit; gates: trunk z in (0.15, 0.4)
             after each cycle, every state finite, every control in
             ctrlrange to 1e-6, cost < initial_cost on every solve, no
             substep kernel launched; prints bench 3's fields, capture
             seconds, graph memory and nodes per piece and per cycle;
  ilqr-trot - bench 3b (:328-394) at full width: Go1 trotting under
             trot_schedule + contact_schedule_cost at 0.5 m/s and 0.265 m
             (horizon 25, 10 x 2 ms substeps, 6 iterations; 25 tracked
             ticks; trot_gait_ref warm start; time reset to 0): the first
             solve cut to its first iteration, graph against eager bit for
             bit; then a capture cycle and TROT_CYCLES timed graph cycles
             (the bench: 10); gates as ilqr, and bench 3b's healthy (trunk
             z above 0.12 at every tick, last cycle's mean in (0.18, 0.4))
             and locomotes (more than 0.1 m forward); prints bench 3b's
             fields;
  realtime - bench.py:104-156 on the port, through bench_torch.py's loop
             functions: 50 graph ticks with a blocking
             copy of the control (the blocking reference), lag = min(5,
             max(1, ceil(median / 20 ms) + 1)), then RealtimeController in
             benchmark mode primed lag + 3 ticks and paced at 20 ms for 100
             ticks (bench.py: 250; 150 before the bridge phases); prints
             bench.py's host-loop fields (p99 / median / max / mean
             host-blocking ms, meets_50hz_budget, overruns, control
             delay, blocking p99 and median); every control finite and in
             ctrlrange, the internal plant's trunk z in (0.12, 0.5) m and
             forward more than 0.5 m, 25 + 1 flat launches per replay;
  bridge   - RealtimeController in bridge mode with delay compensation at
             that lag, 100 ticks paced at 20 ms against a stand-in robot
             (the flat plant step on the card, read to the host before
             each tick, applying each returned control): the same fields
             and gates, 25 rollout + lag + 1 plant launches per tick;
  distill  - MPC -> policy distillation (BASELINE config 5) at the full
             width of the committed command student: Go1, cmd_distill_setup
             (trot_cost_cmd, trot_gait_ref_cmd residual base), the expert
             MPPI K=512, H=25, 2 x 10 ms, sigma 0.10, temperature 0.2,
             anchored with anchor_w 15, batched over S=8 scenarios on the
             eval grid's commands (one launch over S x K = 4096 lanes per
             rollout step), plant 10 x 2 ms (K=8), the 512-256 student with
             the previous control and the command, Adam lr 1e-3, batch 512,
             8 epochs.  The graphed collect tick against the eager one on
             the same injected normals and drive masks for 4 ticks, bit for
             bit; ms per collect tick eager and graph; 2 rounds of 50 ticks
             (beta 1, then 0.93) into an aggregate buffer, each followed by
             3 train_on calls on resamples of 8192 rows; 100 student-only
             eval ticks.  Gates: 25 K=4096 x2 and 1 K=8 x10 launches per
             tick, counted per replay (and once more in the eager warm-up
             tick of each capture); finite losses; every applied control
             in ctrlrange to 1e-6; trunk z in (0.12, 0.45) at every tick of
             round 0.  Prints ms per tick, s per train_on,
             expert_labels_per_sec, action_rmse and the peak memory;
  distill-payload - the same with payload_range (0, 1.5) kg on K2: the
             graph check, one round of 20 ticks and its 3 train_on calls,
             the same gates;
  distill-bench5 - scripts/bench_suite.py:578-622 (5_distill_round):
             OpenDOG standing, S=8, K=64, H=10, the 64-64 student, 50
             ticks; a capture round, then one timed round_fn (10 cost
             launches a tick, L=512) and 100 eval ticks; prints the bench's
             fields;
  student  - the committed runs/distill_go1 and runs/distill_cmd students,
             read without flax (rl/student_io.py) and deployed by
             load_student on the flat plant kernel (K=8 x10) for 100 ticks,
             the command student on the eval grid: finite, trunk z in
             (0.12, 0.45), more than 0.15 m forward (the walking student;
             the command student on its 0.5 m/s command, every command
             upright); prints mean_vx per command beside the artifact's
             record (400 ticks on the JAX package's plant, not a target);
  sharded-1 - the multi-device layer (parallel/, ROADMAP M14) at world
             size 1 in this process, on an NCCL group (initialize_distributed
             on a free port): scripts/bench_suite.py config 6 at full width
             (Go1 flat, trot_cost at 0.5 m/s and 0.265 m, K=256, H=25, 2 x 10
             ms on K1, sigma 0.12, temperature 0.3) sharded over
             sample_mesh(1) equal to make_solver bit for bit on the same
             normals over 5 receding solves; make_mpc(mesh=sample_mesh(1))
             20 ticks eager and 20 replayed from the CUDA graph that holds
             the NCCL all_reduce, equal bit for bit, 26 launches per replay;
             the horizon-sharded associative gains at bench 3's shapes (H=50,
             nx=37, nu=12) and bench 3's make_ilqr solve at H=50 cut to one
             iteration, replayed from its CUDA graphs (graphs=True, the CUDA
             default: the Riccati graph holds the NCCL all_reduces), equal to
             the unsharded ones bit for bit, the capturing solve and a
             replayed one;
             make_sharded_ppo's walk chunk (16 envs x 8 steps, 2 epochs)
             equal to make_ppo's bit for bit; ms of each side;
  sharded-2 - two ranks on the one card over gloo (a free port), started
             with the spawn method, each loading the kernel library built
             above: 5 config-6 solves at K_local=256 per rank, the ranks'
             ctrl, nominal and stats the same bits, rank 0's within 1e-5 of
             the one-process K=512 solve on the same normals, 125 K1
             launches per rank; sharded_suffix_scan (L=51, nx=37) within
             2e-4 of the unsharded scan; ms per solve and the card;
  multidev - the three multi-device scripts, each a subprocess that starts
             its ranks at world size 1 over NCCL (the three at once, each
             in its own process group, killed whole after 420 s), at their full
             per-rank widths, cut in ticks only:
             torch_multiprocess_scaling.py --nprocs 1 --ticks 2 (MPPI on
             OpenDOG at K=64 x H=10 on K1, its solve replayed from a graph
             that holds the NCCL all_reduces; 128 op-graph envs),
             torch_scaling_bench.py --device-counts 1 --steps 2 (64
             WalkEnvs) and torch_comm_volume.py --ranks 1 --reps 2 (Go1
             MPPI at K=4096 x H=25, the horizon-sharded iLQR at H=64, PPO's
             16 x 16 chunk): each record's keys, finite results, backend
             nccl, the comm-volume counts of calls and bytes equal to
             COMM_COUNTS_1, and the K1 launches of the ranks' timed windows
             (2 x 10 at OpenDOG K=64 x2, 2 x 25 at Go1 K=4096 x2), which go
             to those rows;
  mpc-bridge - the robot bridge over the wire (apps/mpc_bridge.py): the
             port's firmware_sim built from native/ with g++ and two of it
             spawned on loopback (the robot's two motor ESP32s: UDP/JSON
             with ACK, 500 Hz PID servo, telemetry); the DigitalTwin's
             advance (10 op-graph substeps, one CUDA graph on its own
             stream) against the eager step bit for bit on 3 advances,
             then 50 advances timed alone in turns on its own and the
             default stream; then make_bridge (OpenDOG trot MPPI, K=256,
             H=25, 2 x 10 ms on K1, lag 3) in a plain and a compensated arm:
             bring-up over the wire, 100 paced 50 Hz ticks (150 before the
             multi-device phases); prints
             MPCBridge.metrics and each tick's parts (twin estimate,
             bridge_tick, set_angles); gates: finite metrics, twin_healthy,
             joint_track_rmse_deg < 8, 25 K1 launches at K=256 x2 per tick
             and, compensated, lag K1 launches at K=1 x10 per tick; then a
             plain arm of 50 ticks (100 before the multi-device phases) with the
             twin's stream alternating
             (own, default) tick by tick;
  student-bridge - scripts/torch_cmd_student_bridge.py --smoke on the card:
             the committed OpenDOG command student (runs/distill_cmd_opendog)
             in StudentBridge.run_segments at 50 Hz over the schedule (T=10,
             120 ticks) against its own firmware pair; gates upright_all,
             prints the other three summary booleans; no kernel launched;
  gait-replay - sim2real/gait_designer.py: a 130-substep row replayed from
             the 128- and 1-substep graphs equal to eager bit for bit; the
             full design_trot (14 rows, 6.8 s of robot time) through
             replay_gait on the card: finite, trunk z above 0.03 m; prints
             the seconds;
  ppo-graph - PPO training (train.py's path; the envs step on the
             op-graph physics, no substep kernel): one chunk's rollout of
             walk, sym and terrain at 16 envs, eager and with the rollout
             step (policy, sample, env step, the reset of every env, the
             autoreset merge, the trajectory write) replayed from its CUDA
             graph, from the same state on the same draws: every trajectory
             buffer, env state field and observation equal bit for bit
             over 1 step (4 before the bridge phases, 2 before the multi-device
             phases); eager ms per step;
  ppo-walk - train("walk") at runs/walk_1's configuration, the CLI
             defaults (16 envs x 128 steps, minibatch 512, 10 epochs,
             64-64, clip): 2 chunks (3 before the bridge phases) and a 250-step
             eval (500 before the multi-device phases);
             replayed ms per rollout step, s per update, env-steps/s, peak
             memory; gates: finite metrics, update_count 2, the parameters
             moved;
  ppo-walk-1024 - one chunk of the same at 1024 envs (10 epochs);
  ppo-tasks - one chunk each of turn, jump, landing, sym (512-256) and
             terrain (1024-512) at their TASKS widths, 16 envs, n_steps
             cut to 8 (the CLI: 128; 32 before the bridge phases, 16 before the
             multi-device phases); sym exports its walk
             json;
  ppo-policy - the committed runs/walk_1 policy (best/970, the .npz of
             rl/policies/) in a 500-step eval on the card, replayed from a
             graph of one step: upright for at least 250 steps and more
             than 0.5 m forward; prints episode_return, episode_len,
             forward_x;
  perception - apps/slam.py, mapping.py, obstacle.py and mono_depth.py on
             OpenDOG's terrain scene and the generated terrain of seed 0
             (relief over 0.05 m), CamConfig() 32 x 24, no substep kernel
             launched: the card against the CPU on the same inputs
             (render_depth at three poses and as their batch, 1e-5 m and
             the same NaN mask; ICP pose and rms 1e-5; fractal heights
             1e-5; the DepthCNN forward with the same weights 1e-4); the
             40-step simulate_walk_localization (bias 0.25) with
             tests/test_slam.py's gates (ICP beats dead reckoning, ICP RMSE
             under half of it, final error under 5 cm); its frames into a
             VoxelMap and one through detect_obstacles and
             ObstacleAvoider.update (finite, counts equal to the CPU's);
             train_depth_net at 48 / 12 / 300 on four terrains and the
             three cross-family arms of 16 frames (fractal terrain,
             overcast shading, both): each beats the mean-depth baseline,
             validation RMSE under half of it; ms per render_depth frame,
             per TerrainLocalizer.update and per Adam step, s per
             train_depth_net;
  apps     - the rest of the package (ROADMAP M15c), no substep kernel
             launched: the SimViewer of apps/viewer_cli.build_viewer on
             OpenDOG flat (home control, paused): 2 ticks replayed from its
             CUDA graph equal to 2 eager ticks on the card bit for bit
             (states and telemetry packets), then 50 ticks, a push tick, a
             set_state and a tick after it against the same on the CPU
             (1e-4 qpos, 1e-3 qvel), ms per replayed tick (CUDA events on
             the viewer's stream), and the telemetry stream of the launched
             viewer read back on loopback by the port's client (at least 3
             packets with the schema's keys, qpos equal to the snapshot's
             to 1e-6); a KeywordSpotter on the card (templates within 1e-4
             of the CPU's, all nine words at the two off-template speakers
             of tests/test_voice_frontend.py, the two gait-machine phrases
             transcribed as on the CPU and parsed to WALK / STOP), ms per
             log_mel; train_cloned_policy: 20 steps replayed from its CUDA
             graph equal to 20 eager steps bit for bit, then at its
             defaults (2000 Adam steps, batch 256) inside
             tests/test_apps_extra.py's 2.5-degree band, its seconds;
             capture_activations of the committed walk policy on 64
             observations equal to the CPU's under flax's keys (within
             1e-5 and 4 float32 ulps of each layer's largest value);
  scripts  - the application scripts (scripts/torch_*.py) on their card
             paths at smoke depth: torch_turn_mpc's run (the Go1 turn MPC
             on K1, K=256 x H=25, 250 ticks replayed from a graph:
             finite, upright, (25 + 1) x 251 flat launches with the
             capture's warm-up), two ticks of torch_jump_mpc's op-graph
             solve on the jump box at its full width (K=512, H=50: finite,
             no kernel launch) and one 500-tick segment of torch_soak_cmd
             (the committed command student runs/distill_cmd on the K1
             plant at K=1: finite, upright, 501 launches; its record beside
             the JAX record runs/distill_cmd/soak.json, mean_vx and yaw_end
             each within 0.01 of it);
  bench-suite - scripts/torch_bench_suite.py's configs that no other
             phase runs, called as functions at full width, cut in
             repetitions only: 1 (OpenDOG's 50-substep op-graph hold, one
             CUDA graph, 5 timed calls; the suite: 40), 2b (Go1 trot MPPI
             at K=4096, 5 warm-up and 5 timed graph ticks; 100 each), 4 (the
             op-graph step over B=4096 OpenDOG envs, 2 timed replays; 20),
             4b (K1 at 4096 x 10 from where 4 ends) and 4d (K2+K3 at
             32,768 x 10), 20 timed launches each (uncut); each config's
             launches counted exactly; gates: healthy (1, 2b), finite (4,
             4b, 4d); prints each record, config 4's capture seconds and
             peak memory;
  profile  - torch.profiler over 3 ticks (10 before the multi-device
             phases) of the flat, terrain and
             exact-terrain loops, eager and graph;
  timing   - CUDA-event times of every kernel at each of its path shapes,
             beside its plain version (one call; the check phase's call is
             its warm-up) and its bound; the tracking-cost kernel's at 256
             and 512 lanes eager and replayed (25 launches a graph), beside
             the op path's step eager and replayed, with its bound
             (utils.profiling.tracking_cost_bound).
The last lines are the wall time, the card's name and power limit, one JSON
object of kernel records, and {"ok": true, "device": {...}}.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
# depths cut to keep the script inside 600 s with the PPO phases (the flat
# and paced loops ran 250 ticks before them, the terrain loops 100), the
# robot bridge's (ops-engine, iLQR, paced-loop and PPO depths, below) and
# the multi-device phases' (ops-engine, PPO, bridge and profile depths:
# "before the multi-device phases")
TICKS = 150            # flat trot loop
TERRAIN_TICKS = 50     # per-geom terrain MPC (the drop from the keyframe
                       # is over by DROP_TICKS; 20 or more ticks after it)
TRUNK_TICKS = 50       # trunk-plane terrain MPC
EXACT_TICKS = TERRAIN_TICKS  # exact-plant terrain MPC, as many as terrain
OPS_SOLVES = 2         # op-graph MPPI solves a side (5 before the bridge's,
                       # 3 before the multi-device phases)
OPS_EQ_SOLVES = 2      # graph vs eager op-graph solves on the same normals
OPS_CHECK_TOL = {"qpos": 1e-4, "qvel": 5e-3}  # op-graph step vs kernel
CPU_CHECK_TOL = {"qpos": 1e-4, "qvel": 1e-3}  # card step vs CPU step
PAYLOAD_SOLVES = 100
PERGEOM_PAYLOAD_SOLVES = 10
PERGEOM_PAYLOAD_KG = 0.5
BATCH_STEPS = 20
EQ_STEPS = 4           # graph vs eager calls on the same normals, per path
SYNC_TICKS = 50        # [realtime] blocking reference ticks (bench.py's n2)
RT_TICKS = 100         # [realtime], [bridge] paced ticks (bench.py's n:
                       # 250; 150 before the bridge phases)
TICK_S = 0.02          # the 50 Hz tick period
# a control is the softmax-weighted mean of plans clipped into ctrlrange;
# float32 rounding of that mean may put it an ulp or so outside
RANGE_TOL = 1e-6
TERRAIN_SEED = 0       # torch.Generator seed on the CPU: not a flat episode
DROP_TICKS = 25        # the keyframe's 0.13 m drop to standing is over by then
# trunk height above the ground under it on the terrain paths: OpenDOG
# stands at 0.069 m; the keyframe starts it at 0.2 m, so the band admits
# 0.21 m until the drop is over
DROP_BAND = (0.03, 0.21)
STAND_BAND = (0.03, 0.15)
MIN_FINAL_X = 0.5      # m trotted forward by the flat loop
CHECK_TOL = {"qpos": 1e-4, "qvel": 1e-3}  # kernel vs plain, max abs error
COST_STEPS = 25        # [check] control steps of the tracking-cost kernel
COST_GAMMA = 0.9       # and their discount
ROLLOUT = dict(K=256, dt=0.01, n=2)
RAGGED = dict(K=257, dt=0.01, n=2)  # one rollout past the MPPI paths' K
PLANT = dict(K=1, dt=0.002, n=10)
BATCH = dict(K=4096, dt=0.002, n=10)
# [bench-suite]: scripts/torch_bench_suite.py's configs 1, 2b, 4, 4b and 4d
# at full width (B and K as the suite's), cut in repetitions only
BENCH_4D = dict(K=32768, dt=0.002, n=10)   # K2+K3, the 32-sphere build
SUITE_HOLD_REPS = 5        # config 1's timed 50-substep calls (the suite: 40)
SUITE_TICKS = 5            # config 2b's warm-up and timed ticks (100 each)
SUITE_BATCH_REPS = 2       # config 4's timed op-graph steps (20)
SUITE_FUSED_REPS = 20      # 4b's and 4d's timed launches (20: uncut)
# [ilqr] and [ilqr-trot] (bench 3 and 3b, scripts/bench_suite.py:305-394):
# full width, cut in cycles only
ILQR_CYCLES = 1        # timed graph cycles of bench 3 after the capture
                       # cycle (2 before the bridge phases)
TROT_CYCLES = 1        # timed graph cycles of bench 3b (the bench: 10; cut
                       # from 4 for the PPO phases, from 2 for the bridge's)
ILQR_Z_BAND = (0.15, 0.4)  # bench 3's healthy trunk z after a cycle
TROT_Z_MIN = 0.12          # bench 3b's healthy: min trunk z over all ticks
TROT_Z_LAST = (0.18, 0.4)  # and the mean over the last cycle
TROT_MIN_DIST = 0.1        # bench 3b's locomotes [m]
# [distill] (BASELINE config 5; scripts/distill_cmd.py): S scenarios, the
# expert's K=512 samples each on one launch of S x K lanes
DISTILL = dict(S=8, rounds=2, ticks=50, eval_ticks=100, train_n=8192,
               trains=3, anchor_w=15.0, beta_decay=0.93)
DISTILL_EXPERT = dict(K=8 * 512, dt=0.01, n=2)
DISTILL_PLANT = dict(K=8, dt=0.002, n=10)
DISTILL_EQ_TICKS = 4       # graph vs eager collect ticks on the same draws
PAYLOAD_DISTILL = dict(ticks=20, payload_hi=1.5)
BENCH5 = dict(S=8, K=64, H=10, ticks=50, eval_ticks=100)
BENCH5_EXPERT = dict(K=8 * 64, dt=0.01, n=2)
STUDENT_TICKS = 100
PROFILE_TICKS = 3          # [profile] ticks per loop and side (10 before the
                           # multi-device phases)
# PPO training (train.py's path): the CLI defaults are runs/walk_1's
# configuration (16 envs x 128 steps, minibatch 512, 10 epochs, 64-64)
PPO_EQ_STEPS = 1           # graph vs eager rollout steps on the same draws
                           # (4 before the bridge phases, 2 before the
                           # multi-device phases)
PPO_EQ_TASKS = ("walk", "sym", "terrain")
PPO_WALK = dict(n_envs=16, n_steps=128, minibatch_size=512, num_epochs=10)
PPO_WALK_CHUNKS = 2        # (3 before the bridge phases)
PPO_WIDE_ENVS = 1024       # the batch the JAX PPO is written for
PPO_WIDE_EPOCHS = 10       # [ppo-walk-1024]'s update, the CLI's
PPO_TASKS = ("turn", "jump", "landing", "sym", "terrain")
PPO_TASK_STEPS = 8         # [ppo-tasks] n_steps (the CLI: 128; 32 before
                           # the bridge phases, 16 before the multi-device
                           # phases)
PPO_EVAL_STEPS = 500       # [ppo-policy]'s eval
PPO_WALK_EVAL_STEPS = 250  # [ppo-walk]'s eval (500 before the multi-device
                           # phases)
POLICY_MIN_STEPS = 250     # the committed walk policy stays upright so long
POLICY_MIN_X = 0.5         # and goes so far forward [m]
PPO_OUT = os.path.join(ROOT, "runs", "torch_smoke")   # gitignored
STUDENT_MIN_X = 0.15       # tests/test_distill.py's forward gate [m]
# [mpc-bridge], [student-bridge], [gait-replay]: the robot bridge over the
# wire (apps/mpc_bridge.py) against two firmware simulators on loopback
BRIDGE = dict(lag=3, ticks=100, samples=256)  # make_bridge, 50 Hz ticks
                           # (150 before the multi-device phases)
BRIDGE_PORT = 19645        # telemetry port; the two firmware sims on +1, +2
STUDENT_BRIDGE_PORT = 19745
BRIDGE_RMSE_DEG = 8.0      # tests/test_mpc_bridge.py's joint tracking gate
TWIN_TICKS = 50            # twin advances timed alone
TWIN_EQ_TICKS = 3          # twin graph vs eager on the same angles
STREAM_AB_TICKS = 50       # plain arm, the twin's stream alternating (100
                           # before the multi-device phases)
STUDENT_BRIDGE_T = 10      # scripts/torch_cmd_student_bridge.py --smoke
GAIT_EQ_SUBSTEPS = 130     # one 128-substep chunk and two single substeps
GAIT_Z_MIN = 0.03          # tests/test_golden_gait_replay.py:203's gate
# [sharded-1], [sharded-2] (ROADMAP M14): scripts/bench_suite.py config 6 at
# full width (Go1 flat, trot_cost at 0.5 m/s and 0.265 m, K=256 per rank,
# H=25, 2 x 10 ms on K1, sigma 0.12, temperature 0.3), cut in depth only
SHARDED_SOLVES = 5         # config-6 solves a side and per rank
SHARDED_TICKS = 20         # make_mpc(mesh=) ticks eager and replayed
SHARDED_ILQR = dict(horizon=50, iterations=1)  # bench 3's solve: 3
                           # iterations
SHARDED_PPO_STEPS = 8      # the walk chunk at world size 1 (the CLI: 128)
SHARDED_RANKS = 2          # two ranks share the one card over gloo
SHARDED_REF = dict(K=SHARDED_RANKS * 256, dt=0.01, n=2)  # one-process solve
SHARDED_TOL = 1e-5         # rank 0 vs the one-process solve (sum order)
SCAN_TOL = 2e-4            # sharded_suffix_scan vs the unsharded scan
SHARDED_TIMEOUT_S = 300    # the spawned ranks, rendezvous included
# [multidev]: the three multi-device scripts at world size 1 over NCCL, at
# their full per-rank widths, cut in ticks only
MULTIDEV_TICKS = 2         # torch_multiprocess_scaling --ticks (the script: 10)
MULTIDEV_STEPS = 2         # torch_scaling_bench --steps (the script: 20)
MULTIDEV_REPS = 2          # torch_comm_volume --reps (the script: 20 / 3 / 2)
MULTIDEV_ROLLOUT = dict(K=64, dt=0.01, n=2)  # the mppi mode's OpenDOG K / rank
MULTIDEV_TIMEOUT_S = 420   # each script, its ranks' rendezvous included
# torch_comm_volume's counts at world size 1 (calls and bytes handed to
# dist.all_reduce), the ones tests/test_torch_scripts_multidev.py asserts
COMM_COUNTS_1 = {
    "mppi_sample_sharded_k4096": dict(
        psum=dict(calls=1, bytes=1212), pmin=dict(calls=1, bytes=4)),
    "ilqr_horizon_sharded_h64": dict(all_gather=dict(calls=4,
                                                     bytes=2207568)),
    "ppo_dp_gradient_allreduce": dict(pmean=dict(calls=13, bytes=424524)),
}
# [perception] (ROADMAP M15b): the JAX package's defaults throughout
PERCEPTION_POSES = ((0.2, 0.1, 0.3), (0.3, -0.2, 0.2), (-1.0, 0.7, 2.5))
PERCEPTION_TOL = dict(render_m=1e-5, icp=1e-5, fractal_m=1e-5, cnn_m=1e-4)
WALK_STEPS = 40            # simulate_walk_localization's default
WALK_FINAL_ERR_M = 0.05    # tests/test_slam.py:89
DEPTH_TRAIN = dict(n_train=48, n_val=12, steps=300)  # the depth scripts'
DEPTH_EVAL_FRAMES = 16     # frames per cross-family arm
PERCEPTION_REPS = 20       # timed render_depth frames, ICP updates, Adam
                           # steps
# [apps] (ROADMAP M15c)
VIEWER_EQ_TICKS = 2        # replayed vs eager viewer ticks on the card
VIEWER_TICKS = 50          # viewer ticks on the card vs the CPU
VIEWER_TIMED_TICKS = 20    # replayed ticks timed by CUDA events
TELEMETRY_TOL = 1e-6       # a packet's qpos vs the snapshot's (float64)
VOICE_TOL = 1e-4           # the card's spotter templates vs the CPU's
VOICE_SPEAKERS = ((125.0, 1.05, 0.02, 1), (100.0, 0.95, 0.03, 2))
VOICE_PHRASES = ((("perrito", "camina"), dict(f0=140.0, rate=1.08,
                                              noise=0.02, seed=11), "camina"),
                 (("perrito", "para"), dict(f0=105.0, rate=0.92, noise=0.03,
                                            seed=12), "para"))
VOICE_REPS = 20            # timed log_mel calls
SCRIPT_TURN_TICKS = 250    # torch_turn_mpc's run, the script's ticks
SCRIPT_JUMP_TICKS = 2      # torch_jump_mpc's op-graph ticks at full width
SCRIPT_SOAK_TICKS = 500    # one segment of torch_soak_cmd (10 s)
# segment 0 vs runs/distill_cmd/soak.json, per key (the card matched the
# record's printed digits, 0.42 and 0.062)
SOAK_RECORD_TOL = {"mean_vx_cmd_frame": 0.01, "yaw_end": 0.01}
CLONING_BAND_DEG = 2.5     # tests/test_apps_extra.py:38-44
CLONING_EQ_STEPS = 20      # graph vs eager cloning steps on the same draws
NNVIS_TOL = 1e-5           # capture_activations, card vs CPU, plus 4 float32
                           # ulps of a layer's largest value (the value head
                           # reaches ~94 on these inputs: an ulp is 7.6e-6)


def free_port():
    """A TCP port on localhost that no socket holds now (bind port 0)."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def random_batch(model, K, seed=1, on_ground=False):
    """Random states around the home keyframe, as the JAX package's
    tests/test_pallas_core.py::_random_batch builds them: (rows, K).  With
    ``on_ground`` the keyframe is first lowered until its lowest collision
    sphere touches z = 0 (OpenDOG's keyframe holds the trunk at 0.2 m,
    13 cm above where it stands)."""
    rng = np.random.default_rng(seed)
    qpos = np.tile(model.numpy("key_qpos")[0], (K, 1)).astype(np.float32)
    if on_ground:
        qpos[:, 2] -= home_clearance(model)
    qpos[:, :3] += rng.normal(0, 0.01, (K, 3))
    qpos[:, 7:] += rng.normal(0, 0.05, (K, model.nq - 7))
    qvel = rng.normal(0, 0.2, (K, model.nv)).astype(np.float32)
    lo, hi = model.numpy("actuator_ctrlrange").T
    ctrl = rng.uniform(lo, hi, (K, model.nu)).astype(np.float32)
    return tuple(np.ascontiguousarray(a.T) for a in (qpos, qvel, ctrl))


def home_clearance(model):
    """Height of the home keyframe's lowest collision sphere above z = 0."""
    import torch
    from opendog_tpu_torch.physics import dynamics, spatial
    m = model.to("cpu")
    xpos, xquat = dynamics.fk(m, m.key_qpos[0])
    R = spatial.quat_to_mat(xquat)
    gb = m.geom_body.long()
    z = xpos[gb, 2] + torch.einsum("gj,gj->g", R[gb, 2, :], m.geom_pos)
    return float((z - m.geom_radius).min())


def random_modes(model, K, with_plane=False, with_payload=False, seed=1):
    """Random inputs of the plane and payload modes, numpy (rows, K) or
    None: planes {n.x = d} near z = 0, tilted as in the JAX package's
    domain-randomised batch (scripts/bench_suite.py:449-454: tilt
    ~N(0, 0.04)) with offsets ~N(0, 0.01), one per rollout (4, K) or one
    per geom and rollout (4 * ngeom, K); payloads U(0, 3) kg (1, K)."""
    rng = np.random.default_rng(seed + 100)
    plane = payload = None
    if with_plane:
        n_planes = model.ngeom if with_plane == "per_geom" else 1
        tilt = rng.normal(0, 0.04, (2, n_planes, K))
        nz = np.sqrt(1.0 - np.clip(tilt[0] ** 2 + tilt[1] ** 2, 0, 0.5))
        d = rng.normal(0, 0.01, (n_planes, K))
        plane = np.stack([tilt[0], tilt[1], nz, d], axis=1)  # (n, 4, K)
        plane = plane.reshape(4 * n_planes, K).astype(np.float32)
    if with_payload:
        payload = rng.uniform(0.0, 3.0, (1, K)).astype(np.float32)
    return plane, payload


def graph_nodes(graph):
    """Nodes of a captured ``torch.cuda.CUDAGraph`` (kept with
    ``keep_graph=True``), from libcuda's ``cuGraphGetNodes``."""
    import ctypes
    lib = ctypes.CDLL("libcuda.so.1")
    n = ctypes.c_size_t(0)
    rc = lib.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), None,
                             ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes returned {rc}")
    return n.value


def terrain_batch(model, terrain, K, seed=2):
    """Random OpenDOG states on the ground of ``terrain`` (random_batch on
    the ground, spread over +-1.5 m in x and y, lifted by the terrain
    height under the trunk) and their own per-geom planes: numpy
    (qpos, qvel, ctrl, plane (4 * ngeom, K))."""
    import torch
    from opendog_tpu_torch.physics import dynamics
    qpos, qvel, ctrl = random_batch(model, K, seed, on_ground=True)
    rng = np.random.default_rng(seed + 200)
    qpos[:2] += rng.uniform(-1.5, 1.5, (2, K)).astype(np.float32)
    m = model.to("cpu")
    t = terrain.to("cpu")
    h, _ = dynamics._terrain_height_normal(m, t, torch.from_numpy(qpos[:2].T))
    qpos[2] += h.numpy()
    planes = dynamics.geom_local_planes(m, t, torch.from_numpy(qpos.T.copy()))
    plane = planes.reshape(K, -1).T.contiguous().numpy()
    return qpos, qvel, ctrl, plane


EXACT_PLANT_CASES = ("terrain", "box", "edge")


def exact_plant_batch(model, terrain, K, case, seed=3):
    """Inputs of the exact plant kernel on OpenDOG's terrain scene: numpy
    (qpos, qvel, ctrl) (rows, K) and the heights (nrow, ncol).  ``case``
    "terrain": random states on the ground of ``terrain`` (terrain_batch's);
    "box": random states over the scene's static box on a flat grid, each
    trunk lowered so that its lowest sphere sinks 0-4 cm into the box top,
    with spheres inside the box and just outside it; "edge": random states
    beyond the heightfield's clipped edge (0.05-0.6 m past +-sx or +-sy),
    on the clipped ground."""
    import torch
    from opendog_tpu_torch.physics import dynamics
    rng = np.random.default_rng(seed + 300)
    heights = terrain.height.detach().cpu().numpy().astype(np.float32)
    if case == "terrain":
        qpos, qvel, ctrl, _ = terrain_batch(model, terrain, K, seed)
        return qpos, qvel, ctrl, heights
    qpos, qvel, ctrl = random_batch(model, K, seed, on_ground=True)
    m = model.to("cpu")
    if case == "box":
        heights = np.zeros_like(heights)
        pos, size = m.numpy("wbox_pos")[0], m.numpy("wbox_size")[0]
        qpos[0] = pos[0] + rng.uniform(-0.5, 0.5, K) * size[0]
        qpos[1] = pos[1] + rng.uniform(-0.5, 0.5, K) * size[1]
        qpos[2] += pos[2] + size[2] - rng.uniform(0.0, 0.04, K)
    elif case == "edge":
        sx, sy = (float(v) for v in m.numpy("hfield_size")[:2])
        past = rng.uniform(0.05, 0.6, (2, K)) * rng.choice([-1, 1], (2, K))
        qpos[0] = np.sign(past[0]) * sx + past[0]
        qpos[1] = rng.uniform(-sy, sy, K)
        swap = rng.uniform(size=K) < 0.5  # past the y edge instead
        qpos[1, swap] = np.sign(past[1, swap]) * sy + past[1, swap]
        qpos[0, swap] = rng.uniform(-sx, sx, int(swap.sum()))
        h, _ = dynamics._terrain_height_normal(
            m, terrain.to("cpu"), torch.from_numpy(qpos[:2].T.copy()))
        qpos[2] += h.numpy()
    else:
        raise ValueError(f"case must be one of {EXACT_PLANT_CASES}")
    return qpos.astype(np.float32), qvel, ctrl, heights


class Smoke:
    """The phases of the run; ``records`` collects one entry per kernel and
    path shape for the JSON line."""

    def __init__(self, torch, dev):
        from opendog_tpu_torch.assets import load_go1, load_opendog
        from opendog_tpu_torch.ops import cuda_step
        from opendog_tpu_torch.physics import terrain as terrain_lib
        self.torch, self.dev, self.cs = torch, dev, cuda_step
        self.go1 = load_go1("flat", device=dev)
        self.dog = load_opendog("flat", device=dev)
        self.dog_t = load_opendog("terrain", device=dev)
        # generated on the CPU from a seed, so that every card gets it
        self.terrain = terrain_lib.generate_terrain(
            self.dog_t, torch.Generator().manual_seed(TERRAIN_SEED))
        self.records = {}
        self.cost_records = {}  # the tracking-cost kernel's, by lane count
        self.pairs = {}  # eager and graph ms per path, for the summary

    # -- check ------------------------------------------------------------
    def check(self, label, model, shape, with_plane, with_payload, arrays,
              keep=True, exclusive=False):
        """Kernel vs plain on ``arrays`` (numpy (rows, K): qpos, qvel, ctrl,
        plane or None, payload or None); keeps the record for timing unless
        ``keep`` is False (a shape that no path launches).  An
        ``exclusive`` record counts only the launches of the phases that
        name it (``counted(rows=...)``)."""
        torch, cs = self.torch, self.cs
        args = [None if a is None else
                torch.from_numpy(np.ascontiguousarray(a)).to(self.dev)
                for a in arrays]
        kern = cs.build_cuda_substep(model, shape["dt"], shape["n"],
                                     device=self.dev, with_plane=with_plane,
                                     with_payload=with_payload)
        plain = cs.build_plain_substep(model, shape["dt"], shape["n"],
                                       with_plane, with_payload)
        kp, kv = kern(*args)
        pp, pv = plain(*args)
        torch.cuda.synchronize()
        err = {"qpos": (kp - pp).abs().max().item(),
               "qvel": (kv - pv).abs().max().item()}
        if not (torch.isfinite(kp).all() and torch.isfinite(kv).all()):
            raise RuntimeError(f"[check] {label}: kernel output not finite")
        K = shape["K"]
        conditioning = ""
        if shape["dt"] >= 0.01:
            # conditioning of these inputs at the rollouts' 10 ms substeps:
            # the plain version's own change when qvel moves by 1e-7
            # relative (a few float32 ulps).  Not at the plants' 2 ms
            # substeps (well conditioned: at most 3.6e-5 there on an H100),
            # where one more plain call costs 3-6 s
            _, pv2 = plain(args[0], args[1] * (1 + 1e-7), *args[2:])
            spread = (pv2 - pv).abs().max(dim=0).values
            conditioning = (
                f"; plain qvel moves by up to {spread.max().item():.3e} "
                f"under a 1e-7 relative change of qvel, by > 1e-4 in "
                f"{int((spread > 1e-4).sum())} of {K} rollouts")
        log(f"[check] {label} K={K} x{shape['n']} dt={shape['dt']}: "
            f"max abs err qpos {err['qpos']:.3e} qvel {err['qvel']:.3e} "
            f"(tolerance {CHECK_TOL['qpos']:.0e} / {CHECK_TOL['qvel']:.0e}; "
            f"max |qvel| {pv.abs().max().item():.3f}{conditioning})")
        for k in err:
            if not err[k] <= CHECK_TOL[k]:
                raise RuntimeError(f"[check] {label}: kernel disagrees with "
                                   f"its plain version on {k}: {err[k]}")
        if not keep:
            return
        self.records[label] = dict(
            model=model, shape=shape, err=max(err.values()), args=args,
            kern=kern, plain=plain, launches=0, name=kern.name,
            key=cs.launch_key(K, shape["n"], with_plane, with_payload),
            modes=(with_plane, with_payload), exclusive=exclusive)

    def check_all(self):
        torch, go1, dog, dog_t = self.torch, self.go1, self.dog, self.dog_t
        suite = script_module("torch_bench_suite")
        none = (None, None)
        self.check("flat rollout", go1, ROLLOUT, False, False,
                   random_batch(go1, ROLLOUT["K"]) + none)
        self.check("flat plant", go1, PLANT, False, False,
                   random_batch(go1, PLANT["K"]) + none)
        K = ROLLOUT["K"]
        self.check("payload rollout", go1, ROLLOUT, False, True,
                   random_batch(go1, K) + random_modes(go1, K, False, True))
        self.check("plane rollout", dog_t, ROLLOUT, True, False,
                   random_batch(dog_t, K, on_ground=True)
                   + random_modes(dog_t, K, True))
        self.check("pergeom rollout", dog_t, ROLLOUT, "per_geom", False,
                   terrain_batch(dog_t, self.terrain, K) + (None,))
        self.check("pergeom plant", dog_t, PLANT, "per_geom", False,
                   terrain_batch(dog_t, self.terrain, PLANT["K"]) + (None,))
        self.check("plane_payload batch", dog, BATCH, True, True,
                   suite.batch_inputs(dog, BATCH["K"]))
        self.check("pergeom_payload rollout", dog_t, ROLLOUT, "per_geom",
                   True, terrain_batch(dog_t, self.terrain, K)
                   + random_modes(dog_t, K, False, True)[1:])
        Kd, Kp = DISTILL_EXPERT["K"], DISTILL_PLANT["K"]
        self.check("flat distill expert", go1, DISTILL_EXPERT, False, False,
                   random_batch(go1, Kd) + none)
        self.check("flat distill plant", go1, DISTILL_PLANT, False, False,
                   random_batch(go1, Kp) + none)
        self.check("payload distill expert", go1, DISTILL_EXPERT, False, True,
                   random_batch(go1, Kd) + random_modes(go1, Kd, False, True))
        self.check("payload distill plant", go1, DISTILL_PLANT, False, True,
                   random_batch(go1, Kp) + random_modes(go1, Kp, False, True))
        self.check("flat bench5 expert", dog, BENCH5_EXPERT, False, False,
                   random_batch(dog, BENCH5_EXPERT["K"], on_ground=True)
                   + none)
        # the robot bridge (make_bridge): OpenDOG flat MPPI rollouts and
        # the compensated solve's predictor; their launches are counted by
        # the bridge phases alone
        self.check("flat bridge rollout", dog, ROLLOUT, False, False,
                   random_batch(dog, K, on_ground=True) + none,
                   exclusive=True)
        self.check("flat bridge predictor", dog, PLANT, False, False,
                   random_batch(dog, PLANT["K"], on_ground=True) + none,
                   exclusive=True)
        # [sharded-2]'s one-process reference: config 6 at K = 2 x 256; its
        # launches are counted by that phase alone (bench 5's expert shares
        # the shape)
        self.check("flat sharded reference", go1, SHARDED_REF, False, False,
                   random_batch(go1, SHARDED_REF["K"]) + none,
                   exclusive=True)
        # [multidev]'s mppi mode: OpenDOG at 64 rollouts per rank; its
        # launches are counted in the script's rank and read by that phase
        self.check("flat multidev rollout", dog, MULTIDEV_ROLLOUT, False,
                   False, random_batch(dog, MULTIDEV_ROLLOUT["K"],
                                       on_ground=True) + none,
                   exclusive=True)
        # [bench-suite]: configs 4b (K1 on config 4's start, OpenDOG) and
        # 4d (the 32-sphere K2+K3 build at 32,768 scenarios)
        start = suite.batch_start(dog, suite.batch_draws(dog))
        self.check("flat bench4b", dog, BATCH, False, False,
                   tuple(x.T.cpu().numpy() for x in start) + none)
        self.check("plane_payload bench4d", dog, BENCH_4D, True, True,
                   suite.batch_inputs(dog, BENCH_4D["K"]))
        # the launch counter keys by shape, not model: bench 5's OpenDOG
        # plant counts under the Go1 plant's row
        self.check("flat bench5 plant", dog, DISTILL_PLANT, False, False,
                   random_batch(dog, Kp, on_ground=True) + none, keep=False)
        Kr = RAGGED["K"]
        self.check("flat ragged", go1, RAGGED, False, False,
                   random_batch(go1, Kr) + none, keep=False)
        self.check("payload ragged", go1, RAGGED, False, True,
                   random_batch(go1, Kr) + random_modes(go1, Kr, False, True),
                   keep=False)
        self.check("plane ragged", dog_t, RAGGED, True, False,
                   random_batch(dog_t, Kr, on_ground=True)
                   + random_modes(dog_t, Kr, True), keep=False)
        self.check("pergeom ragged", dog_t, RAGGED, "per_geom", False,
                   terrain_batch(dog_t, self.terrain, Kr) + (None,),
                   keep=False)
        self.check("plane_payload ragged", dog, RAGGED, True, True,
                   suite.batch_inputs(dog, Kr), keep=False)
        self.check("pergeom_payload ragged", dog_t, RAGGED, "per_geom", True,
                   terrain_batch(dog_t, self.terrain, Kr)
                   + random_modes(dog_t, Kr, False, True)[1:], keep=False)
        self.check_exact_plant()
        # the rollouts' tracking cost (standing_cost) at every lane count
        # that a path launches it: the terrain loops and the per-geom
        # payload solves (256 lanes after K3 and after K4) and bench 5's
        # expert (8 x 64 lanes, OpenDOG flat); check only: [multidev]'s
        # multi-process MPPI (64 a rank; its rank counts the substep
        # launches alone), the benchmark's per-geom cell (4096), Go1
        # (nu = 12, no path of the smoke) and a ragged 257
        self.check_cost("terrain", dog_t, K, True)
        self.check_cost("terrain pergeom", dog_t, K, "per_geom", keep=False)
        self.check_cost("bench5 expert", dog, BENCH5_EXPERT["K"], False)
        self.check_cost("multidev rollout", dog, MULTIDEV_ROLLOUT["K"],
                        False, keep=False)
        self.check_cost("pergeom k4096", dog_t, 4096, "per_geom", keep=False)
        self.check_cost("go1", go1, K, False, height=0.265, keep=False)
        self.check_cost("ragged", dog_t, Kr, True, keep=False)
        self.cs.COST_LAUNCHES.clear()

    def check_cost(self, label, model, K, with_plane, height=0.0694,
                   keep=True):
        """The rollouts' tracking-cost kernel (rollout_tracking_cost)
        against the op path it replaces (the standing cost's closure on the
        carry, times the discount, added to the total) at K lanes over
        COST_STEPS control steps of the rollouts' substep kernel (K1 flat,
        K3 on a trunk plane, K4 per geom on the generated terrain) from the
        home keyframe on the ground, its joints perturbed by N(0, 0.03)
        rad, ``height`` the standing cost's target above the ground there:
        every step's cost and the discounted total bit for bit.  Keeps the
        last step's inputs for timing unless ``keep`` is False."""
        torch, dev, cs = self.torch, self.dev, self.cs
        from opendog_tpu_torch.physics import State, dynamics
        from opendog_tpu_torch.solvers import costs
        gen = torch.Generator(device=dev).manual_seed(5)
        qpos = model.key_qpos[0][None].repeat(K, 1)
        h0, plane = 0.0, {}
        if with_plane:
            terr = self.terrain.to(dev)
            h0 = float(dynamics._terrain_height_normal(
                model, terr, torch.zeros(1, 2, device=dev))[0][0])
        qpos[:, 2] += h0
        qpos[:, 7:] += 0.03 * torch.randn(K, model.nq - 7, device=dev,
                                          generator=gen)
        if with_plane == "per_geom":
            rows = dynamics.geom_local_planes(model, terr, qpos).reshape(K,
                                                                         -1)
            plane = dict(plane=rows.T.contiguous())
        elif with_plane:
            h, n = dynamics._terrain_height_normal(model, terr, qpos[:, :2])
            p0 = torch.stack([qpos[:, 0], qpos[:, 1], h], dim=-1)
            plane = dict(plane=torch.cat(
                [n, torch.sum(n * p0, dim=-1)[:, None]], dim=-1).T
                .contiguous())
        cost = costs.standing_cost(model, height + h0, model.key_qpos[0, 7:])
        kern = cs.TrackingCostKernel(model, *cost.tracking, dev)
        rng = model.actuator_ctrlrange
        cand = torch.clamp(model.key_ctrl[0] + 0.08 * torch.randn(
            K, COST_STEPS, model.nu, device=dev, generator=gen), rng[:, 0],
            rng[:, 1])
        ctrl_rows = cand.permute(1, 2, 0).contiguous()
        psub = cs.build_cuda_substep(model, 0.01, 2, device=dev,
                                     with_plane=with_plane)
        qp = qpos.T.contiguous()
        qv = torch.zeros(model.nv, K, device=dev)
        t = torch.zeros(K, device=dev)
        want = got = None
        disc, step_gap = 1.0, 0.0
        for h in range(COST_STEPS):
            qp, qv = psub(qp, qv, ctrl_rows[h], **plane)
            st = State(qpos=qp.T, qvel=qv.T, time=t)
            args = (qp, qv, ctrl_rows[h], ctrl_rows[max(h - 1, 0)], disc)
            op_args = (st, cand[:, h], cand[:, max(h - 1, 0)])
            c = cost(*op_args) * disc
            one = kern(*args)
            if not torch.equal(one, c):
                step_gap = max(step_gap, (one - c).abs().nan_to_num(
                    nan=float("inf")).max().item())
            want = c if want is None else want + c
            got = kern(*args, got)
            disc = disc * COST_GAMMA
        torch.cuda.synchronize()
        finite = bool(torch.isfinite(want).all())
        total_gap = (0.0 if torch.equal(got, want) else (got - want).abs()
                     .nan_to_num(nan=float("inf")).max().item())
        ground = ("per-geom planes" if with_plane == "per_geom"
                  else "a trunk plane" if with_plane else "flat")
        log(f"[check] cost {label} L={K} ({model.nu} controls, {ground}), "
            f"{COST_STEPS} steps: kernel vs op path max abs gap, a step "
            f"{step_gap:.3e}, the total {total_gap:.3e} (must be equal bit "
            f"for bit); op-path total finite {finite}")
        if step_gap or total_gap or not finite:
            raise RuntimeError(f"[check] cost {label}: the kernel differs "
                               f"from the op path (a step {step_gap}, the "
                               f"total {total_gap}) or the total is not "
                               f"finite ({finite})")
        if not keep:
            return
        self.cost_records[label] = dict(
            model=model, K=K, err=0.0, launches=0,
            key=cs.cost_launch_key(K),
            kernel=lambda: kern(*args, got),
            op=lambda: want + cost(*op_args) * args[-1])

    def check_exact_plant(self):
        """The exact plant kernel against its plain version at the MPC
        plant's K=1 x 10, in each case of exact_plant_batch (check only:
        its launches count in PLANT_LAUNCHES, which the exact-terrain loop
        reads)."""
        torch, dev, cs = self.torch, self.dev, self.cs
        from opendog_tpu_torch.ops import scalar_core
        K, n, dt = PLANT["K"], PLANT["n"], PLANT["dt"]
        plain = cs.build_plain_substep(self.dog_t, dt, n, scalar_core.TERRAIN)
        for case in EXACT_PLANT_CASES:
            qp, qv, ct, heights = (
                torch.from_numpy(a).to(dev) for a in
                exact_plant_batch(self.dog_t, self.terrain, K, case))
            kp, kv = cs.ExactPlant(self.dog_t, dt, n, heights, dev)(qp, qv,
                                                                    ct)
            pp, pv = plain(qp, qv, ct, heights)
            torch.cuda.synchronize()
            err = {"qpos": (kp - pp).abs().max().item(),
                   "qvel": (kv - pv).abs().max().item()}
            log(f"[check] exact plant {case} K={K} x{n} dt={dt}: max abs "
                f"err qpos {err['qpos']:.3e} qvel {err['qvel']:.3e}")
            for k in err:
                if not err[k] <= CHECK_TOL[k]:
                    raise RuntimeError(f"[check] exact plant {case}: kernel "
                                       f"disagrees with its plain version "
                                       f"on {k}: {err[k]}")
        cs.PLANT_LAUNCHES.clear()

    # -- paths ------------------------------------------------------------
    def counted(self, label, run, want, rows=None, want_cost=None):
        """Runs ``run()`` with every launch count set to 0 just before and
        read just after; the counts must equal ``want`` exactly, and the
        tracking-cost kernel's ``want_cost`` where it is given.  The
        launches go to the kernel records of their shape, or with ``rows``
        to the named records alone (the counter keys by shape, not model:
        the bridge's OpenDOG rows share the Go1 rows' shapes)."""
        cs = self.cs
        cs.LAUNCHES.clear()
        cs.COST_LAUNCHES.clear()
        out = run()
        self.torch.cuda.synchronize()
        launches, cost = dict(cs.LAUNCHES), dict(cs.COST_LAUNCHES)
        log(f"[{label}] kernel launches: {launches}; cost kernel: {cost}")
        if launches != want:
            raise RuntimeError(f"[{label}] kernel launches {launches} != "
                               f"{want}")
        if want_cost is not None and cost != want_cost:
            raise RuntimeError(f"[{label}] cost kernel launches {cost} != "
                               f"{want_cost}")
        self.attribute(launches, rows)
        for rec in self.cost_records.values():
            rec["launches"] += cost.get(rec["key"], 0)
        return out

    def attribute(self, launches, rows=None):
        """Adds the counts of a path's run to the kernel records of their
        shape (to the named records alone with ``rows``)."""
        for name, rec in self.records.items():
            if (name in rows) if rows is not None else not rec["exclusive"]:
                rec["launches"] += launches.get(rec["key"], 0)

    def graph_matches(self, label, step, gstep, first, n=None,
                      calls=EQ_STEPS):
        """The graphed step against the eager one on the same injected
        normals for ``calls`` calls, each side from ``first``:
        ``step(prev, normals)`` returns (next, outputs), where outputs is a
        dict of tensors; every output must be equal bit for bit."""
        torch = self.torch
        gen = torch.Generator(device=self.dev).manual_seed(11)
        e = g = first
        differ, keys = {}, set()
        for _ in range(calls):
            normals = torch.randn(n, device=self.dev, generator=gen)
            e, oe = step(e, normals)
            g, og = gstep(g, normals)
            for k, a in oe.items():
                keys.add(k)
                if not torch.equal(a, og[k]):
                    d = (a - og[k]).abs().nan_to_num(nan=float("inf"))
                    differ[k] = max(differ.get(k, 0.0), d.max().item())
        torch.cuda.synchronize()
        verdict = (f"DIFFER, max abs {differ}" if differ
                   else "equal bit for bit")
        log(f"[{label}] graph vs eager over {calls} calls on the same "
            f"normals: {', '.join(sorted(keys))} {verdict}")
        if differ:
            raise RuntimeError(f"[{label}] the graph differs from the eager "
                               f"path: max abs {differ}")

    def tick_pair(self, label, tick, init, s0, cfg, nu, run_loop, want,
                  want_cost):
        """The eager tick and its CUDA graph (captured from the loop's first
        carry): bit for bit on injected normals, then ``run_loop`` on each
        from the same generator seed, with the launches counted per replay
        (the cost kernel's too).  Returns {side: (wall, loop result, last
        carry)} and the graphed tick."""
        torch, dev = self.torch, self.dev
        from opendog_tpu_torch.solvers import graph_tick
        n = (cfg.num_samples, cfg.horizon, nu)
        first = init(torch.Generator(device=dev).manual_seed(0), s0)
        t0 = time.perf_counter()
        gtick = graph_tick(tick, first, torch.zeros(n, device=dev))
        torch.cuda.synchronize()
        log(f"[{label}] captured the tick in {time.perf_counter() - t0:.3f} "
            f"s: {sum(gtick.graph.launches.values())} substep launches per "
            f"replay {dict(gtick.graph.launches)}")
        def step(fn):
            def call(carry, normals):
                carry, out = fn(carry, normals)
                return carry, dict(ctrl=out["ctrl"], qpos=out["qpos"],
                                   qvel=out["qvel"],
                                   nominal=carry.solver.nominal)
            return call

        self.graph_matches(label, step(tick), step(gtick), first, n)
        out = {}
        for side, fn in (("eager", tick), ("graph", gtick)):
            carry = init(torch.Generator(device=dev).manual_seed(0), s0)
            out[side] = self.counted(f"{label} {side}",
                                     lambda: run_loop(fn, carry), want,
                                     want_cost=want_cost)
        return out, gtick

    def flat_loop(self):
        torch, dev, cs = self.torch, self.dev, self.cs
        from opendog_tpu_torch.physics import make_state
        from opendog_tpu_torch.solvers import MPPIConfig, costs, make_mpc
        model = self.go1
        params = costs.TrotCostParams(desired_vel_xy=(0.5, 0.0),
                                      target_height=0.265)
        cost = costs.trot_cost(model, params, model.key_qpos[0, 7:],
                               legs="go1")
        cfg = MPPIConfig(horizon=25, num_samples=256, n_substeps=2,
                         rollout_dt=0.01, noise_sigma=0.12, temperature=0.3)
        init, tick, _ = make_mpc(model, cost, cfg, plant_substeps=10,
                                 device=dev)
        warm = init(torch.Generator(device=dev).manual_seed(1),
                    make_state(model, "home"))
        for _ in range(3):
            warm, _ = tick(warm)
        torch.cuda.synchronize()

        def run(fn, carry):
            zs, finite = [], []
            t0 = time.perf_counter()
            for _ in range(TICKS):
                carry, out = fn(carry)
                zs.append(out["qpos"][2].clone())
                finite.append(torch.isfinite(out["qpos"]).all()
                              & torch.isfinite(out["qvel"]).all())
            torch.cuda.synchronize()
            return time.perf_counter() - t0, zs, finite, out, carry

        want = {cs.launch_key(ROLLOUT["K"], ROLLOUT["n"]): cfg.horizon * TICKS,
                cs.launch_key(PLANT["K"], PLANT["n"]): TICKS}
        res, gtick = self.tick_pair("main", tick, init,
                                    make_state(model, "home"), cfg, model.nu,
                                    run, want, {})  # the trot cost: its ops
        for side, (wall, zs, finite, out, carry) in res.items():
            z = torch.stack(zs).cpu().numpy()
            all_finite = bool(torch.stack(finite).all().item())
            final_x = float(carry.plant.qpos[0].item())
            log(f"[main] {side}: {TICKS} ticks in {wall:.3f} s: "
                f"{1e3 * wall / TICKS:.3f} ms/tick, {TICKS / wall:.2f} "
                f"solves/s | final_x {final_x:.3f} m | trunk z min "
                f"{z.min():.4f} max {z.max():.4f} | finite {all_finite} | "
                f"best_cost {float(out['best_cost']):.3f} ess "
                f"{float(out['ess']):.2f}")
            if not ((z > 0.12) & (z < 0.5)).all():
                raise RuntimeError(f"[main] {side}: trunk height left "
                                   "(0.12, 0.5) m")
            if not all_finite:
                raise RuntimeError(f"[main] {side}: non-finite plant state")
            if not final_x > MIN_FINAL_X:
                raise RuntimeError(f"[main] {side}: final_x {final_x:.3f} m "
                                   f"<= {MIN_FINAL_X} m")
        self.log_pair("main", res, TICKS, "tick")
        same = torch.equal(res["eager"][4].plant.qpos,
                           res["graph"][4].plant.qpos)
        log(f"[main] the graph loop, drawing its normals from the same "
            f"generator seed, ends on the eager loop's plant state: {same}")
        if not same:
            raise RuntimeError("[main] the graph loop drew other normals "
                               "than the eager loop")
        carry = init(torch.Generator(device=dev).manual_seed(0),
                     make_state(model, "home"))
        return dict(tick=tick, gtick=gtick, carry=carry, model=model,
                    cost=cost, cfg=cfg)

    def log_pair(self, label, res, n, unit):
        """Eager and graph ms per tick or solve, side by side."""
        e, g = (1e3 * res[side][0] / n for side in ("eager", "graph"))
        log(f"[{label}] ms/{unit}: eager {e:.3f}, graph {g:.3f} ({e / g:.2f}x"
            f", same call, {n} {unit}s each)")
        self.pairs[label] = dict(eager_ms=e, graph_ms=g, n=n, unit=unit)

    def terrain_loop(self, label, plane_mode, ticks, terrain_plant="kernel"):
        """OpenDOG standing MPC on the generated terrain: the per-geom
        kernel plant, or the exact plant (the exact plant kernel)."""
        torch, dev, cs = self.torch, self.dev, self.cs
        from opendog_tpu_torch.physics import dynamics, make_state
        from opendog_tpu_torch.solvers import MPPIConfig, costs, make_mpc
        model, terr = self.dog_t, self.terrain
        span = float(terr.height.max() - terr.height.min())
        h0 = float(dynamics._terrain_height_normal(
            model, terr, torch.zeros(1, 2, device=dev))[0][0])
        log(f"[{label}] terrain seed {TERRAIN_SEED}: heights span "
            f"{span:.4f} m, ground under the start {h0:.4f} m")
        if not span > 0.05:
            raise RuntimeError(f"[{label}] the terrain is flat")
        cost = costs.standing_cost(model, 0.0694 + h0, model.key_qpos[0, 7:])
        cfg = MPPIConfig(horizon=25, num_samples=256, n_substeps=2,
                         rollout_dt=0.01, noise_sigma=0.08, temperature=0.3)
        init, tick, _ = make_mpc(model, cost, cfg, plant_substeps=10,
                                 device=dev, terrain=terr,
                                 terrain_plant=terrain_plant,
                                 plane_mode=plane_mode)
        s0 = make_state(model, "home")
        s0.qpos[2] += h0  # the bench's +0.151 on a flat episode
        warm = init(torch.Generator(device=dev).manual_seed(1), s0)
        for _ in range(3):
            warm, _ = tick(warm)
        torch.cuda.synchronize()

        def run(fn, carry):
            qs = []
            t0 = time.perf_counter()
            for _ in range(ticks):
                carry, out = fn(carry)
                qs.append(torch.cat([out["qpos"], out["qvel"]]))
            torch.cuda.synchronize()
            return time.perf_counter() - t0, torch.stack(qs), carry

        rollout_mode = "per_geom" if plane_mode == "per_geom" else True
        want = {cs.launch_key(ROLLOUT["K"], ROLLOUT["n"], rollout_mode):
                cfg.horizon * ticks}
        if terrain_plant == "kernel":  # the exact plant counts apart
            want[cs.launch_key(PLANT["K"], PLANT["n"], "per_geom")] = ticks
        # the standing cost: one launch of its kernel a control step
        cost_key = cs.cost_launch_key(cfg.num_samples)
        res, gtick = self.tick_pair(label, tick, init, s0, cfg, model.nu,
                                    run, want,
                                    {cost_key: cfg.horizon * ticks})
        per_replay = dict(gtick.graph.count_of(cs.COST_LAUNCHES))
        log(f"[{label}] cost kernel launches per replay: {per_replay}")
        if per_replay != {cost_key: cfg.horizon}:
            raise RuntimeError(f"[{label}] cost kernel launches per replay "
                               f"{per_replay} != {{{cost_key!r}: "
                               f"{cfg.horizon}}}")
        plant = dict(gtick.graph.count_of(cs.PLANT_LAUNCHES))
        want_plant = ({cs.plant_launch_key(PLANT["K"], PLANT["n"]): 1}
                      if terrain_plant == "exact" else {})
        log(f"[{label}] exact plant launches per replay: {plant}")
        if plant != want_plant:
            raise RuntimeError(f"[{label}] exact plant launches {plant} != "
                               f"{want_plant}")
        for side, (wall, qs, _) in res.items():
            qpos = qs[:, :model.nq]
            ground, _ = dynamics._terrain_height_normal(model, terr,
                                                        qpos[:, :2])
            clear = (qpos[:, 2] - ground).cpu().numpy()
            finite = bool(torch.isfinite(qs).all().item())
            settled = clear[DROP_TICKS:]
            log(f"[{label}] {side}: {ticks} ticks in {wall:.3f} s: "
                f"{1e3 * wall / ticks:.3f} ms/tick | trunk above ground: min "
                f"{clear.min():.4f} max {clear.max():.4f}, from tick "
                f"{DROP_TICKS} min {settled.min():.4f} max "
                f"{settled.max():.4f}, last {clear[-1]:.4f} | xy drift "
                f"{float(qpos[-1, :2].norm()):.4f} m | finite {finite}")
            if not finite:
                raise RuntimeError(f"[{label}] {side}: non-finite plant "
                                   "state")
            lo, hi = DROP_BAND
            if not ((clear > lo) & (clear < hi)).all():
                raise RuntimeError(f"[{label}] {side}: trunk left "
                                   f"{DROP_BAND} m above the ground")
            lo, hi = STAND_BAND
            if not ((settled > lo) & (settled < hi)).all():
                raise RuntimeError(f"[{label}] {side}: trunk left "
                                   f"{STAND_BAND} m above the ground after "
                                   f"tick {DROP_TICKS}")
        self.log_pair(label, res, ticks, "tick")
        carry = init(torch.Generator(device=dev).manual_seed(0), s0)
        return dict(tick=tick, gtick=gtick, carry=carry, ticks=ticks,
                    final_qpos={side: r[2].plant.qpos.clone()
                                for side, r in res.items()})

    def deviation(self, kernel, exact):
        """bench 2c_pergeom's honesty check (scripts/bench_suite.py:
        207-214): the trunk position that the kernel-plant loop reaches
        against the one the exact-plant loop reaches from the same start on
        the same normals (each drawn from generator seed 0) in as many
        ticks, eager and replayed."""
        if kernel["ticks"] != exact["ticks"]:
            raise RuntimeError("[terrain] the deviation needs as many exact "
                               "ticks as kernel-plant ticks")
        dev = {side: float((kernel["final_qpos"][side][:3]
                            - exact["final_qpos"][side][:3]).norm())
               for side in ("eager", "graph")}
        log(f"[terrain] final_dev_vs_exact_plant_m: {dev['eager']:.3e} "
            f"(graph loops: {dev['graph']:.3e}) after {kernel['ticks']} "
            f"ticks: per-geom rollouts and kernel plant against trunk-plane "
            f"rollouts and the exact plant (bench 2c), same start and "
            f"normals; not gated")
        return dev

    def ops_check(self):
        """The op-graph step on the card against the flat kernel and against
        itself on the CPU, on random Go1 states."""
        torch, dev, cs = self.torch, self.dev, self.cs
        from opendog_tpu_torch.physics import State, dynamics
        model, K = self.go1, ROLLOUT["K"]
        rows = random_batch(model, K)
        qp, qv, ct = (torch.from_numpy(a.T.copy()) for a in rows)

        def step(m, device):
            return dynamics.step(m, State(
                qpos=qp.to(device), qvel=qv.to(device),
                time=torch.zeros(K, device=device)), ct.to(device))

        got, info = step(model, dev)
        kern = cs.build_cuda_substep(model, model.timestep, 1, device=dev)
        kq, kv = kern(*(torch.from_numpy(a).to(dev) for a in rows))
        cpu, _ = step(model.to("cpu"), "cpu")
        torch.cuda.synchronize()
        if not (torch.isfinite(got.qpos).all() and torch.isfinite(
                got.qvel).all() and torch.isfinite(
                info.contact.force_world).all()):
            raise RuntimeError("[ops-check] the step's output is not finite")
        errs = {
            "kernel": {"qpos": (got.qpos - kq.T).abs().max().item(),
                       "qvel": (got.qvel - kv.T).abs().max().item()},
            "cpu": {"qpos": (got.qpos.cpu() - cpu.qpos).abs().max().item(),
                    "qvel": (got.qvel.cpu() - cpu.qvel).abs().max().item()}}
        for what, tol in (("kernel", OPS_CHECK_TOL), ("cpu", CPU_CHECK_TOL)):
            e = errs[what]
            log(f"[ops-check] dynamics.step on the card vs "
                f"{'the flat kernel' if what == 'kernel' else 'the CPU'} on "
                f"random Go1 states, K={K} x1 dt={model.timestep}: max abs "
                f"err qpos {e['qpos']:.3e} qvel {e['qvel']:.3e} (tolerance "
                f"{tol['qpos']:.0e} / {tol['qvel']:.0e})")
            for k in e:
                if not e[k] <= tol[k]:
                    raise RuntimeError(f"[ops-check] the step disagrees with "
                                       f"{what} on {k}: {e[k]}")

    def ops_engine(self):
        """Op-graph MPPI of Go1 standing on the jump scene's box: the graphed
        solve against the eager one, then OPS_SOLVES solves a side."""
        torch, dev = self.torch, self.dev
        from opendog_tpu_torch.assets import load_go1
        from opendog_tpu_torch.physics import make_state
        from opendog_tpu_torch.solvers import MPPIConfig, costs, graph_solve, mppi
        model = load_go1("jump", device=dev)
        box_top = float((model.wbox_pos[0, 2] + model.wbox_size[0, 2]).item())
        cost = costs.standing_cost(model, 0.265 + box_top,
                                   model.key_qpos[0, 7:])
        cfg = MPPIConfig(horizon=25, num_samples=256, n_substeps=2,
                         rollout_dt=0.01, noise_sigma=0.12, temperature=0.3,
                         engine="ops")
        solve = mppi.make_solver(model, cost, cfg, device=dev)
        st = make_state(model, "home")
        st.qpos[0] += float(model.wbox_pos[0, 0].item())  # over the box
        st.qpos[2] += box_top
        ms0 = mppi.init_state(model, cfg)
        n = (cfg.num_samples, cfg.horizon, model.nu)
        t0 = time.perf_counter()
        gsolve = graph_solve(solve, st, ms0, torch.zeros(n, device=dev))
        torch.cuda.synchronize()
        log(f"[ops-engine] captured the solve in "
            f"{time.perf_counter() - t0:.3f} s: substep launches per replay "
            f"{dict(gsolve.graph.launches)}")

        def step(fn):
            def call(ms, normals):
                ctrl, ms, stats = fn(st, ms, None, normals)
                return ms, dict(ctrl=ctrl, nominal=ms.nominal, **stats)
            return call

        self.graph_matches("ops-engine", step(solve), step(gsolve), ms0, n,
                           calls=OPS_EQ_SOLVES)
        res = {}
        for side, fn in (("eager", solve), ("graph", gsolve)):
            gen = torch.Generator(device=dev).manual_seed(0)

            def run():
                ms, outs = ms0, []
                t0 = time.perf_counter()
                for _ in range(OPS_SOLVES):
                    ctrl, ms, stats = fn(st, ms, gen)
                    outs.append(torch.cat([ctrl, ms.nominal.reshape(-1)]
                                          + [v.reshape(1)
                                             for v in stats.values()]))
                torch.cuda.synchronize()
                return time.perf_counter() - t0, torch.stack(outs), stats

            res[side] = self.counted(f"ops-engine {side}", run, {})
            wall, outs, stats = res[side]
            finite = bool(torch.isfinite(outs).all().item())
            log(f"[ops-engine] {side}: {OPS_SOLVES} solves of Go1 on the "
                f"jump box in {wall:.3f} s: {1e3 * wall / OPS_SOLVES:.3f} "
                f"ms/solve | best_cost {float(stats['best_cost']):.4f} ess "
                f"{float(stats['ess']):.2f} | finite {finite}")
            if not finite:
                raise RuntimeError(f"[ops-engine] {side}: non-finite solve "
                                   "output")
        self.log_pair("ops-engine", res, OPS_SOLVES, "solve")

    # -- iLQR ---------------------------------------------------------------
    def settled_go1(self, time_zero=False):
        """Go1's home state settled for 200 substeps under the home
        control (the start of bench 3 and 3b)."""
        from opendog_tpu_torch.physics import dynamics, make_state
        m = self.go1
        s, _ = dynamics.step(m, make_state(m, "home"), m.key_ctrl[0], None,
                             n_substeps=200)
        if time_zero:
            s.time = self.torch.zeros((), device=self.dev)
        return s

    def ilqr_cycles(self, label, cycle, s0, U0, n_cycles):
        """The capture cycle from (s0, U0), then ``n_cycles`` timed cycles
        of the graphed tracker ``cycle``: every plant state finite, every
        control in ctrlrange to RANGE_TOL and ``cost < initial_cost`` on
        every solve, no substep kernel launched.  Prints the capture
        seconds, the graphs' memory, each piece's nodes and the nodes
        replayed per cycle."""
        torch = self.torch
        m = self.go1
        rng = m.actuator_ctrlrange
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        out = dict(cycles=[])

        def one(plant, U):
            t0 = time.perf_counter()
            plant, U, traj = cycle(plant, U)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            st = cycle.stats
            q, c = traj["qpos"], traj["ctrl"]
            finite = bool(torch.isfinite(q).all() and torch.isfinite(c).all()
                          and torch.isfinite(plant.qvel).all())
            in_range = bool(((c >= rng[:, 0] - RANGE_TOL)
                             & (c <= rng[:, 1] + RANGE_TOL)).all())
            cost, c0 = float(st["cost"]), float(st["initial_cost"])
            log(f"[{label}] cycle in {wall:.3f} s: cost {cost:.4f} from "
                f"{c0:.4f}, iterations' costs "
                f"{[round(float(v), 4) for v in st['cost_trace']]}, step "
                f"sizes taken {st['pick_trace'].tolist()} | trunk z min "
                f"{float(q[:, 2].min()):.4f} max {float(q[:, 2].max()):.4f} "
                f"last {float(plant.qpos[2]):.4f}, x {float(plant.qpos[0]):.4f}"
                f" | finite {finite}, controls in range {in_range}")
            if not finite:
                raise RuntimeError(f"[{label}] non-finite plant state")
            if not in_range:
                raise RuntimeError(f"[{label}] a control left ctrlrange")
            if not cost < c0:
                raise RuntimeError(f"[{label}] the solve did not lower the "
                                   f"cost: {cost} from {c0}")
            return wall, plant, U, dict(qpos=q.clone(), ctrl=c.clone(),
                                        cost=traj["cost"].clone())

        def run():
            wall, plant, U, traj = one(s0, U0)
            out["capture_s"], out["first"] = wall, (plant, U, traj)
            calls = {}
            for _ in range(n_cycles):
                before = {**cycle.pieces.calls, **cycle.solve.pieces.calls}
                wall, plant, U, traj = one(plant, U)
                after = {**cycle.pieces.calls, **cycle.solve.pieces.calls}
                calls = {f: after[f] - before.get(f, 0) for f in after}
                out["cycles"].append((wall, plant, U, traj))
            return calls

        calls = self.counted(label, run, {})
        mem = (torch.cuda.max_memory_allocated() - mem0) / 2 ** 20
        graphs = {**cycle.pieces.captured, **cycle.solve.pieces.captured}
        nodes = {f.__name__: (graph_nodes(g.graph), calls[f])
                 for f, g in graphs.items()}
        out["nodes_per_cycle"] = sum(n * k for n, k in nodes.values())
        out["nodes"] = nodes
        out["memory_mib"] = mem
        log(f"[{label}] capture cycle (one eager warm-up, one capture and "
            f"one replay of each piece) {out['capture_s']:.3f} s; peak "
            f"memory above the start {mem:.1f} MiB; graph nodes per piece "
            f"(nodes, replays per cycle): {nodes}; "
            f"{out['nodes_per_cycle']} nodes replayed per cycle")
        return out

    def ilqr(self):
        """bench 3 (scripts/bench_suite.py:305-326): Go1 standing under
        whole-body iLQR, 1 Hz replan + 50 Hz tracking."""
        torch, dev = self.torch, self.dev
        from opendog_tpu_torch.solvers import (ILQRConfig, costs,
                                               make_ilqr_tracker)
        m = self.go1
        cost = costs.standing_cost(m, 0.265, m.key_qpos[0, 7:])
        icfg = ILQRConfig(horizon=50, n_substeps=2, rollout_dt=0.01,
                          iterations=3)
        kw = dict(track_ticks=50, plant_substeps=10, device=dev)
        s0 = self.settled_go1()
        U0 = m.key_ctrl[0][None].repeat(icfg.horizon, 1)
        log(f"[ilqr] bench 3 at full width: Go1 flat, standing_cost(0.265),"
            f" {icfg}, track_ticks 50, plant_substeps 10; cut: "
            f"{ILQR_CYCLES} timed graph cycles after the capture cycle and "
            f"one eager cycle (the bench: one timed cycle)")
        g = self.ilqr_cycles("ilqr", make_ilqr_tracker(m, cost, icfg,
                                                       graphs=True, **kw),
                             s0, U0, ILQR_CYCLES)
        for wall, plant, _, _ in g["cycles"]:
            z = float(plant.qpos[2])
            if not ILQR_Z_BAND[0] < z < ILQR_Z_BAND[1]:
                raise RuntimeError(f"[ilqr] trunk z {z} left {ILQR_Z_BAND}")
        # the eager cycle from the first timed cycle's start
        plant1, U1, _ = g["first"]
        ecycle = make_ilqr_tracker(m, cost, icfg, graphs=False, **kw)
        e = self.counted("ilqr eager", lambda: self._eager_cycle(
            "ilqr", ecycle, plant1, U1), {})
        wall_g, plant_g, U_g, traj_g = g["cycles"][0]
        wall_e, plant_e, U_e, traj_e = e
        self.same_bits("ilqr", "graph vs eager, the eager cycle and the "
                       "first timed graph cycle", dict(traj_g, plant_qpos=plant_g.qpos,
                                     plant_qvel=plant_g.qvel, U_next=U_g),
                       dict(traj_e, plant_qpos=plant_e.qpos,
                            plant_qvel=plant_e.qvel, U_next=U_e))
        dt = float(np.mean([c[0] for c in g["cycles"]]))
        z = float(g["cycles"][-1][1].qpos[2])
        fields = dict(cycle_seconds=dt, realtime_factor=1.0 / dt, trunk_z=z,
                      healthy=bool(ILQR_Z_BAND[0] < z < ILQR_Z_BAND[1]),
                      eager_cycle_seconds=wall_e,
                      capture_cycle_seconds=g["capture_s"],
                      graph_memory_mib=g["memory_mib"],
                      graph_nodes_per_cycle=g["nodes_per_cycle"],
                      timed_cycles=ILQR_CYCLES)
        log(f"[ilqr] bench 3 fields: {json.dumps(fields)}")
        self.pairs["ilqr"] = dict(eager_ms=1e3 * wall_e, graph_ms=1e3 * dt,
                                  n=1, unit="cycle")
        return fields

    def _eager_cycle(self, label, cycle, plant, U):
        t0 = time.perf_counter()
        plant, U, traj = cycle(plant, U)
        self.torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        log(f"[{label}] eager cycle in {wall:.3f} s: cost "
            f"{float(traj['cost']):.4f}")
        return wall, plant, U, traj

    def same_bits(self, label, what, a, b):
        """Every tensor of ``a`` equals its namesake in ``b`` bit for bit;
        ``what`` names the two sides."""
        torch = self.torch
        differ = {k: float((a[k] - b[k]).abs().nan_to_num(
                      nan=float("inf")).max())
                  for k in a if not torch.equal(a[k], b[k])}
        verdict = f"DIFFER, max abs {differ}" if differ else "equal bit for bit"
        log(f"[{label}] {what}: {', '.join(sorted(a))} {verdict}")
        if differ:
            raise RuntimeError(f"[{label}] {what} differ: {differ}")

    def ilqr_trot(self):
        """bench 3b (scripts/bench_suite.py:328-394): Go1 trotting under an
        explicit contact schedule, 0.5 s replan + 50 Hz tracking, warm
        started from the gait reference."""
        torch, dev = self.torch, self.dev
        from dataclasses import replace
        from opendog_tpu_torch.solvers import (ILQRConfig, costs, make_ilqr,
                                               make_ilqr_tracker)
        m = self.go1
        home_j = m.key_qpos[0, 7:]
        pc = costs.TrotCostParams(desired_vel_xy=(0.5, 0.0),
                                  target_height=0.265)
        sched = costs.trot_schedule(pc, legs="go1")
        cost = costs.contact_schedule_cost(m, sched, pc, home_j, legs="go1")
        icfg = ILQRConfig(horizon=25, n_substeps=10, rollout_dt=0.002,
                          iterations=6)
        u_ref = costs.trot_gait_ref(m, pc, home_j, legs="go1")
        s0 = self.settled_go1(time_zero=True)
        U0 = m.key_ctrl[0][None].repeat(icfg.horizon, 1)
        log(f"[ilqr-trot] bench 3b at full width: Go1 flat, trot_schedule + "
            f"contact_schedule_cost at 0.5 m/s and 0.265 m, {icfg}, "
            f"track_ticks 25, plant_substeps 10, u_ref_fn trot_gait_ref; "
            f"cut: {TROT_CYCLES} timed graph cycles after the capture cycle "
            f"(the bench: 10), graph vs eager on the first solve's first "
            f"iteration only")
        # graph vs eager: the first solve, cut to its first iteration
        one = replace(icfg, iterations=1)
        sides = {}
        for side, graphs in (("graph", True), ("eager", False)):
            solve = make_ilqr(m, cost, one, device=dev, graphs=graphs)

            def run():
                t0 = time.perf_counter()
                U, X, st = solve(s0, U0)
                torch.cuda.synchronize()
                return time.perf_counter() - t0, dict(st, U=U, X=X)

            sides[side] = self.counted(f"ilqr-trot first iteration {side}",
                                       run, {})
            log(f"[ilqr-trot] one-iteration solve, {side}: "
                f"{sides[side][0]:.3f} s (graph: with its captures)")
        self.same_bits("ilqr-trot",
                       "graph vs eager, the first solve's first iteration",
                       sides["graph"][1], sides["eager"][1])
        cycle = make_ilqr_tracker(m, cost, icfg, track_ticks=25,
                                  plant_substeps=10, u_ref_fn=u_ref,
                                  device=dev, graphs=True)
        g = self.ilqr_cycles("ilqr-trot", cycle, s0, U0, TROT_CYCLES)
        x0 = float(g["first"][0].qpos[0])
        walls = [c[0] for c in g["cycles"]]
        dt = float(np.mean(walls))
        zs = torch.cat([c[3]["qpos"][:, 2] for c in g["cycles"]])
        z_last = g["cycles"][-1][3]["qpos"][:, 2]
        dist = float(g["cycles"][-1][1].qpos[0]) - x0
        fields = dict(cycle_seconds=dt, realtime_factor=0.5 / dt,
                      distance_m=dist,
                      mean_speed_mps=dist / (0.5 * TROT_CYCLES),
                      locomotes=bool(dist > TROT_MIN_DIST),
                      trunk_z_min=float(zs.min()),
                      trunk_z_last_cycle_mean=float(z_last.mean()),
                      trunk_z_final=float(g["cycles"][-1][1].qpos[2]),
                      capture_cycle_seconds=g["capture_s"],
                      graph_memory_mib=g["memory_mib"],
                      graph_nodes_per_cycle=g["nodes_per_cycle"],
                      eager_first_iteration_seconds=sides["eager"][0],
                      timed_cycles=TROT_CYCLES)
        fields["healthy"] = bool(
            fields["trunk_z_min"] > TROT_Z_MIN
            and TROT_Z_LAST[0] < fields["trunk_z_last_cycle_mean"]
            < TROT_Z_LAST[1])
        log(f"[ilqr-trot] bench 3b fields: {json.dumps(fields)}")
        if not fields["healthy"]:
            raise RuntimeError(f"[ilqr-trot] unhealthy: trunk z min "
                               f"{fields['trunk_z_min']} (> {TROT_Z_MIN}), "
                               f"last-cycle mean "
                               f"{fields['trunk_z_last_cycle_mean']} (in "
                               f"{TROT_Z_LAST})")
        if not fields["locomotes"]:
            raise RuntimeError(f"[ilqr-trot] {dist} m is not more than "
                               f"{TROT_MIN_DIST} m")
        self.pairs["ilqr-trot"] = dict(graph_ms=1e3 * dt, n=TROT_CYCLES,
                                       unit="cycle")
        return fields

    def solve_pair(self, label, pay, st, ms0, payload, cfg, n_solves, want,
                   want_cost):
        """A payload solver and its CUDA graph: bit for bit on injected
        normals, then ``n_solves`` solves on each from the same generator
        seed with the launches counted per replay (the cost kernel's too);
        the solve outputs must be finite."""
        torch, dev = self.torch, self.dev
        from opendog_tpu_torch.solvers import graph_solve
        n = (cfg.num_samples,) + tuple(ms0.nominal.shape)
        t0 = time.perf_counter()
        gsolve = graph_solve(pay, st, ms0, torch.zeros(n, device=dev),
                             payload)
        torch.cuda.synchronize()
        log(f"[{label}] captured the solve in "
            f"{time.perf_counter() - t0:.3f} s: launches per replay "
            f"{dict(gsolve.graph.launches)}")

        def step(fn):
            def call(ms, normals):
                ctrl, ms, stats = fn(st, ms, None, normals, payload)
                return ms, dict(ctrl=ctrl, nominal=ms.nominal, **stats)
            return call

        self.graph_matches(label, step(pay), step(gsolve), ms0, n)
        res = {}
        for side, fn in (("eager", pay), ("graph", gsolve)):
            gen = torch.Generator(device=dev).manual_seed(0)

            def run():
                ms, ctrls = ms0, []
                t0 = time.perf_counter()
                for _ in range(n_solves):
                    ctrl, ms, stats = fn(st, ms, gen, None, payload)
                    ctrls.append(ctrl.clone())
                torch.cuda.synchronize()
                return time.perf_counter() - t0, torch.stack(ctrls), stats

            res[side] = self.counted(f"{label} {side}", run, want,
                                     want_cost=want_cost)
            wall, ctrls, stats = res[side]
            finite = bool(torch.isfinite(ctrls).all().item()) and all(
                bool(torch.isfinite(v).all().item()) for v in stats.values())
            log(f"[{label}] {side}: {n_solves} solves with {payload} kg in "
                f"{wall:.3f} s: {1e3 * wall / n_solves:.3f} ms/solve | "
                f"best_cost {float(stats['best_cost']):.4f} | finite {finite}")
            if not finite:
                raise RuntimeError(f"[{label}] {side}: non-finite solve "
                                   "output")
        self.log_pair(label, res, n_solves, "solve")

    def payload_solves(self):
        torch, dev, cs = self.torch, self.dev, self.cs
        from opendog_tpu_torch.physics import make_state
        from opendog_tpu_torch.solvers import MPPIConfig, costs, mppi
        model = self.go1
        params = costs.TrotCostParams(desired_vel_xy=(0.5, 0.0),
                                      target_height=0.265)
        cost = costs.trot_cost(model, params, model.key_qpos[0, 7:],
                               legs="go1")
        cfg = MPPIConfig(horizon=25, num_samples=256, n_substeps=2,
                         rollout_dt=0.01, noise_sigma=0.12, temperature=0.3)
        flat = mppi.make_solver(model, cost, cfg, device=dev)
        pay = mppi.make_solver(model, cost, cfg, device=dev,
                               with_payload=True)
        st, ms0 = make_state(model, "home"), mppi.init_state(model, cfg)
        normals = torch.randn(
            (cfg.num_samples, cfg.horizon, model.nu), device=dev,
            generator=torch.Generator(device=dev).manual_seed(3))
        c_f, m_f, s_f = flat(st, ms0, None, normals)
        c_0, m_0, s_0 = pay(st, ms0, None, normals, 0.0)
        c_h, _, s_h = pay(st, ms0, None, normals, 1.5)
        d0 = max((c_0 - c_f).abs().max().item(),
                 (m_0.nominal - m_f.nominal).abs().max().item(),
                 abs(float(s_0["best_cost"]) - float(s_f["best_cost"])))
        dh = abs(float(s_h["best_cost"]) - float(s_0["best_cost"]))
        log(f"[payload] 0 kg vs the flat solver: max abs difference {d0:.3e} "
            f"(tolerance 1e-6); 1.5 kg moves best_cost by {dh:.4f} "
            f"({float(s_0['best_cost']):.4f} -> {float(s_h['best_cost']):.4f})")
        if not d0 <= 1e-6:
            raise RuntimeError(f"[payload] 0 kg differs from the flat "
                               f"solver by {d0}")
        if not dh > 1e-3:
            raise RuntimeError("[payload] 1.5 kg does not change best_cost")
        want = {cs.launch_key(ROLLOUT["K"], ROLLOUT["n"], False, True):
                cfg.horizon * PAYLOAD_SOLVES}
        self.solve_pair("payload", pay, st, ms0, 1.5, cfg, PAYLOAD_SOLVES,
                        want, {})  # the trot cost: its ops

    def pergeom_payload_solves(self):
        """Per-geom terrain MPPI of OpenDOG standing on the generated
        terrain, carrying a payload."""
        torch, dev, cs = self.torch, self.dev, self.cs
        from opendog_tpu_torch.physics import dynamics, make_state
        from opendog_tpu_torch.solvers import MPPIConfig, costs, mppi
        model, terr = self.dog_t, self.terrain
        h0 = float(dynamics._terrain_height_normal(
            model, terr, torch.zeros(1, 2, device=dev))[0][0])
        cost = costs.standing_cost(model, 0.0694 + h0, model.key_qpos[0, 7:])
        cfg = MPPIConfig(horizon=25, num_samples=256, n_substeps=2,
                         rollout_dt=0.01, noise_sigma=0.08, temperature=0.3)
        pg = mppi.make_solver(model, cost, cfg, device=dev, terrain=terr,
                              plane_mode="per_geom")
        pay = mppi.make_solver(model, cost, cfg, device=dev, terrain=terr,
                               plane_mode="per_geom", with_payload=True)
        st = make_state(model, "home")
        st.qpos[2] += h0 + 0.0694 - float(model.key_qpos[0, 2])  # standing
        ms0 = mppi.init_state(model, cfg)
        normals = torch.randn(
            (cfg.num_samples, cfg.horizon, model.nu), device=dev,
            generator=torch.Generator(device=dev).manual_seed(3))
        c_f, m_f, s_f = pg(st, ms0, None, normals)
        c_0, m_0, s_0 = pay(st, ms0, None, normals, 0.0)
        c_h, _, s_h = pay(st, ms0, None, normals, PERGEOM_PAYLOAD_KG)
        d0 = max((c_0 - c_f).abs().max().item(),
                 (m_0.nominal - m_f.nominal).abs().max().item(),
                 abs(float(s_0["best_cost"]) - float(s_f["best_cost"])))
        dh = abs(float(s_h["best_cost"]) - float(s_0["best_cost"]))
        log(f"[pergeom-payload] 0 kg vs the per-geom solver: max abs "
            f"difference {d0:.3e} (tolerance 1e-6); {PERGEOM_PAYLOAD_KG} kg "
            f"moves best_cost by {dh:.4f} ({float(s_0['best_cost']):.4f} -> "
            f"{float(s_h['best_cost']):.4f})")
        if not d0 <= 1e-6:
            raise RuntimeError(f"[pergeom-payload] 0 kg differs from the "
                               f"per-geom solver by {d0}")
        if not dh > 1e-6:
            raise RuntimeError("[pergeom-payload] the payload does not "
                               "change best_cost")
        want = {cs.launch_key(cfg.num_samples, cfg.n_substeps, "per_geom",
                              True): cfg.horizon * PERGEOM_PAYLOAD_SOLVES}
        self.solve_pair("pergeom-payload", pay, st, ms0, PERGEOM_PAYLOAD_KG,
                        cfg, PERGEOM_PAYLOAD_SOLVES, want,
                        {cs.cost_launch_key(cfg.num_samples):
                         cfg.horizon * PERGEOM_PAYLOAD_SOLVES})

    def realtime(self, flat):
        """bench.py:104-156 on the port, through bench_torch.py's loop: the
        blocking reference (the graphed tick plus a blocking copy of its
        control), the pipeline depth from its median, then
        RealtimeController in benchmark mode paced at 50 Hz; the
        host-blocking time of each tick."""
        import bench_torch
        torch, dev, cs = self.torch, self.dev, self.cs
        from opendog_tpu_torch.physics import make_state
        from opendog_tpu_torch.solvers import RealtimeController
        model, cfg, gtick, carry = (flat[k] for k in ("model", "cfg", "gtick",
                                                      "carry"))
        _, lat_sync = bench_torch.blocking_reference(gtick, carry, SYNC_TICKS)
        sync_p99 = float(np.percentile(lat_sync, 99) * 1e3)
        sync_median = float(np.median(lat_sync) * 1e3)
        lag = bench_torch.lag_for(sync_median)
        log(f"[realtime] blocking reference over {SYNC_TICKS} graph ticks: "
            f"median {sync_median:.3f} ms, p99 {sync_p99:.3f} ms -> lag {lag}")
        rtc = RealtimeController(model, flat["cost"], cfg, lag=lag,
                                 plant_substeps=10, device=dev,
                                 generator=torch.Generator(
                                     device=dev).manual_seed(0))
        start_s = bench_torch.prime(rtc, make_state(model, "home"), lag)
        log(f"[realtime] start() captured the tick in {start_s:.3f} s")
        want = {cs.launch_key(ROLLOUT["K"], ROLLOUT["n"]):
                cfg.horizon * RT_TICKS,
                cs.launch_key(PLANT["K"], PLANT["n"]): RT_TICKS}
        lat, ctrls, overruns = self.counted(
            "realtime", lambda: bench_torch.paced_loop(rtc, RT_TICKS), want)
        rtc.drain()
        qpos = rtc.plant.qpos.cpu().numpy()
        fields = dict(bench_torch.loop_fields(lat, overruns, lag),
                      host_loop_sync_p99_ms=sync_p99,
                      host_loop_sync_median_ms=sync_median)
        self.check_loop("realtime", model, ctrls, qpos, fields)
        return fields

    def check_loop(self, label, model, ctrls, qpos, fields):
        """Prints a paced loop's fields and gates its controls and plant:
        finite, in ctrlrange to RANGE_TOL, trunk z in (0.12, 0.5) m,
        forward more than MIN_FINAL_X."""
        fields.update(plant_z=float(qpos[2]), final_x=float(qpos[0]))
        log(f"[{label}] {len(ctrls)} ticks paced at {TICK_S * 1e3:.0f} ms: "
            + json.dumps(fields))
        rng = model.numpy("actuator_ctrlrange")
        if not (ctrls.shape == (len(ctrls), model.nu)
                and np.isfinite(ctrls).all()):
            raise RuntimeError(f"[{label}] a control is not finite")
        out_of_range = float(np.maximum(np.maximum(rng[:, 0] - ctrls,
                                                   ctrls - rng[:, 1]),
                                        0).max())
        log(f"[{label}] controls leave ctrlrange by at most "
            f"{out_of_range:.3e} (tolerance {RANGE_TOL:.0e})")
        if not out_of_range <= RANGE_TOL:
            raise RuntimeError(f"[{label}] a control left ctrlrange")
        if not 0.12 < qpos[2] < 0.5:
            raise RuntimeError(f"[{label}] trunk z {qpos[2]:.4f} m left "
                               "(0.12, 0.5)")
        if not qpos[0] > MIN_FINAL_X:
            raise RuntimeError(f"[{label}] final_x {qpos[0]:.3f} m <= "
                               f"{MIN_FINAL_X} m")

    def bridge(self, flat, lag):
        """RealtimeController in bridge mode with delay compensation at
        ``lag``, paced at 50 Hz against a stand-in robot: the flat cell's
        plant step (K1, K=1 x10) on the card, whose state is read to the
        host before each tick and which applies each returned control.
        Times what bridge_tick blocks its caller, as [realtime] does."""
        import bench_torch
        torch, dev, cs = self.torch, self.dev, self.cs
        from opendog_tpu_torch.physics import make_state
        from opendog_tpu_torch.solvers import RealtimeController
        model, cfg = flat["model"], flat["cfg"]
        robot = cs.build_cuda_substep(model, model.timestep, PLANT["n"],
                                      device=dev)
        rtc = RealtimeController(model, flat["cost"], cfg, lag=lag,
                                 plant_substeps=PLANT["n"], compensate=True,
                                 device=dev, generator=torch.Generator(
                                     device=dev).manual_seed(1))
        st = make_state(model, "home")
        qpos, qvel, t = st.qpos[:, None], st.qvel[:, None], 0.0

        def tick():
            nonlocal qpos, qvel, t
            q, v = qpos[:, 0].cpu().numpy(), qvel[:, 0].cpu().numpy()
            t0 = time.perf_counter()
            ctrl = rtc.bridge_tick(q, v, t)
            blocked = time.perf_counter() - t0
            qpos, qvel = robot(qpos, qvel, torch.from_numpy(ctrl).to(
                dev)[:, None].contiguous())
            t += TICK_S
            return blocked, ctrl

        t0 = time.perf_counter()
        tick()  # captures the compensated solve
        log(f"[bridge] first bridge_tick (captures the solve) "
            f"{time.perf_counter() - t0:.3f} s")
        for _ in range(lag + 3):
            time.sleep(TICK_S)
            tick()

        def run():
            lat = np.zeros(RT_TICKS)
            ctrls, overruns = [], 0
            next_t = time.perf_counter()
            for i in range(RT_TICKS):
                next_t += TICK_S
                lat[i], ctrl = tick()
                ctrls.append(ctrl)
                rest = next_t - time.perf_counter()
                if rest > 0:
                    time.sleep(rest)
                else:
                    overruns += 1
                    next_t = time.perf_counter()
            return lat, np.array(ctrls), overruns

        # the compensated solve rolls lag plant steps; the robot steps once
        want = {cs.launch_key(ROLLOUT["K"], ROLLOUT["n"]):
                cfg.horizon * RT_TICKS,
                cs.launch_key(PLANT["K"], PLANT["n"]): (lag + 1) * RT_TICKS}
        lat, ctrls, overruns = self.counted("bridge", run, want)
        rtc.drain()
        fields = bench_torch.loop_fields(lat, overruns, lag)
        self.check_loop("bridge", model, ctrls, qpos[:, 0].cpu().numpy(),
                        fields)
        return fields

    def batch_steps(self):
        torch, dev, cs = self.torch, self.dev, self.cs
        model, K = self.dog, BATCH["K"]
        step = cs.build_cuda_substep(model, BATCH["dt"], BATCH["n"],
                                     device=dev, with_plane=True,
                                     with_payload=True)
        qp, qv, ct, plane, payload = (
            torch.from_numpy(a).to(dev) for a in script_module(
                "torch_bench_suite").batch_inputs(model, K))

        def run():
            nonlocal qp, qv
            t0 = time.perf_counter()
            for _ in range(BATCH_STEPS):
                qp, qv = step(qp, qv, ct, plane, payload)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        want = {cs.launch_key(K, BATCH["n"], True, True): BATCH_STEPS}
        wall = self.counted("batch", run, want)
        finite = bool((torch.isfinite(qp).all()
                       & torch.isfinite(qv).all()).item())
        z = qp[2]
        log(f"[batch] {BATCH_STEPS} steps of K={K} x{BATCH['n']} in "
            f"{wall:.4f} s: {1e3 * wall / BATCH_STEPS:.4f} ms/step, "
            f"{K * BATCH_STEPS / wall:.0f} scenario-ticks/s | trunk z "
            f"{float(z.min()):.4f}..{float(z.max()):.4f} | finite {finite}")
        if not finite:
            raise RuntimeError("[batch] non-finite state")

    # -- distillation (BASELINE config 5) ---------------------------------
    def settled_state(self, model):
        """scripts/distill_cmd.py's start: home settled 150 substeps under
        the hold control, at rest, time 0."""
        from opendog_tpu_torch.physics import State, dynamics, make_state
        torch = self.torch
        rng = model.actuator_ctrlrange
        hold = torch.clamp(model.key_ctrl[0], rng[:, 0], rng[:, 1])
        s0, _ = dynamics.step(model, make_state(model, "home"), hold, None,
                              n_substeps=150)
        return State(qpos=s0.qpos, qvel=torch.zeros_like(s0.qvel),
                     time=torch.zeros((), device=self.dev))

    def check_trace(self, label, model, trace, z_band):
        """Every applied control finite and in ctrlrange to RANGE_TOL; with
        ``z_band``, every trunk z inside it."""
        torch = self.torch
        rng = model.actuator_ctrlrange
        c, q = trace["ctrl"], trace["qpos"]
        out = float(torch.clamp(torch.maximum(rng[:, 0] - c, c - rng[:, 1]),
                                min=0).max())
        finite = bool(torch.isfinite(c).all() and torch.isfinite(q).all())
        z = q[..., 2]
        log(f"[{label}] {c.shape[0]} ticks x {c.shape[1]} scenarios: "
            f"controls leave ctrlrange by at most {out:.3e} (tolerance "
            f"{RANGE_TOL:.0e}), trunk z {float(z.min()):.4f}..."
            f"{float(z.max()):.4f}, finite {finite}")
        if not finite:
            raise RuntimeError(f"[{label}] non-finite control or state")
        if not out <= RANGE_TOL:
            raise RuntimeError(f"[{label}] a control left ctrlrange by {out}")
        if z_band is not None and not bool(((z > z_band[0])
                                            & (z < z_band[1])).all()):
            raise RuntimeError(f"[{label}] trunk z left {z_band}")

    def distill(self, label, payload_hi, rounds, ticks, eval_ticks):
        """The command distiller at full width (see the module docstring):
        graph vs eager, ``rounds`` rounds of ``ticks`` collect ticks with
        their train_on calls, ``eval_ticks`` eval ticks."""
        torch, dev, cs = self.torch, self.dev, self.cs
        from dataclasses import replace
        from opendog_tpu_torch.physics import State, spatial
        from opendog_tpu_torch.rl.distill import DistillConfig, make_distiller
        from opendog_tpu_torch.rl.distill_zoo import cmd_distill_setup
        from opendog_tpu_torch.solvers import mppi
        script = script_module("torch_distill_cmd")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        setup = cmd_distill_setup("go1", engine="kernel", device=dev)
        m, mcfg, S = setup.model, setup.mppi_config, DISTILL["S"]
        use_payload = payload_hi > 0
        cfg = DistillConfig(num_scenarios=S, rollout_ticks=ticks, lr=1e-3,
                            batch_size=512, epochs_per_round=8,
                            beta_decay=DISTILL["beta_decay"])

        def make(graphs, T):
            return make_distiller(
                m, setup.cost, setup.obs_fn, setup.net, mcfg,
                replace(cfg, rollout_ticks=T), plant_substeps=10,
                action_ref_fn=setup.u_ref, with_prev_ctrl=True,
                command_dim=3, anchor_w=DISTILL["anchor_w"],
                payload_range=(0.0, payload_hi) if use_payload else None,
                device=dev, graphs=graphs)

        log(f"[{label}] Go1 cmd_distill_setup, {mcfg}, anchor_w "
            f"{DISTILL['anchor_w']}, S={S} on the eval grid's commands, "
            f"plant 10 x 2 ms, student 512-256 on {setup.net.obs_dim} "
            f"inputs, {cfg}"
            + (f", payloads U(0, {payload_hi}) kg" if use_payload else ""))
        gen = torch.Generator(device=dev).manual_seed(0)
        s0 = self.settled_state(m)
        plants = State(qpos=script.jitter(torch, spatial, gen, s0.qpos, S,
                                          yaw_range=0.6),
                       qvel=torch.zeros(S, m.nv, device=dev),
                       time=torch.zeros(S, device=dev))
        cmds = torch.tensor(script.EVAL_CMDS_BY_ROBOT["go1"], device=dev)
        payloads = (torch.from_numpy(np.random.default_rng(0).uniform(
            0.0, payload_hi, S).astype(np.float32)).to(dev)
            if use_payload else None)
        dmain = make(True, ticks)
        dstate = dmain.init(gen, s0)
        ms0 = mppi.init_state(m, mcfg, scenarios=S)
        K, H = mcfg.num_samples, mcfg.horizon

        def want(n_ticks):
            return {cs.launch_key(S * K, mcfg.n_substeps, False, use_payload):
                    H * n_ticks,
                    cs.launch_key(S, 10, False, use_payload): n_ticks}

        # graph vs eager on the same injected draws
        EQ = DISTILL_EQ_TICKS
        g2 = torch.Generator(device=dev).manual_seed(5)
        normals = torch.randn((EQ, S, K, H, m.nu), generator=g2, device=dev)
        drive = torch.rand((EQ, S, 1), generator=g2, device=dev) < 0.5
        sides, walls = {}, {}
        for side, graphs in (("graph", True), ("eager", False)):
            d = make(graphs, EQ)
            st = d.init(None, s0, params=dstate.params)
            for call in range(2):
                # a graph's first call runs the tick once eagerly (its
                # warm-up), captures it and replays it EQ times
                trace = {}
                t0 = time.perf_counter()
                p2, ms2, _, obs, labels = self.counted(
                    f"{label} check {side}", lambda: d.collect(
                        st, plants, ms0, 0.5, payloads, cmds, normals, drive,
                        trace), want(EQ + int(graphs and call == 0)))
                walls[(side, call)] = time.perf_counter() - t0
            sides[side] = dict(obs=obs, labels=labels, plant_qpos=p2.qpos,
                               plant_qvel=p2.qvel, plant_time=p2.time,
                               nominal=ms2.nominal, **trace)
        self.same_bits(label, f"graph vs eager, the first {EQ} collect "
                       "ticks on the same normals and drive masks", sides["graph"],
                       sides["eager"])
        e, g = (1e3 * walls[(side, 1)] / EQ for side in ("eager", "graph"))
        log(f"[{label}] ms per collect tick: eager {e:.3f}, graph {g:.3f} "
            f"({e / g:.2f}x, same call, {EQ} ticks each, after a first call "
            f"of {1e3 * walls[('graph', 0)] / EQ:.3f} ms/tick graph with its "
            f"capture and {1e3 * walls[('eager', 0)] / EQ:.3f} eager)")
        self.pairs[label] = dict(eager_ms=e, graph_ms=g, n=EQ,
                                 unit="collect tick")

        # rounds into an aggregate buffer, each with its train_on calls
        rng = np.random.default_rng(0)
        buf_obs, buf_lab, fields = [], [], dict(rounds=[])
        for r in range(rounds):
            beta = DISTILL["beta_decay"] ** r
            trace = {}

            def run():
                t0 = time.perf_counter()
                out = dmain.collect(dstate, plants, ms0, beta, payloads, cmds,
                                    trace=trace)
                torch.cuda.synchronize()
                return time.perf_counter() - t0, out

            # round 0 captures the tick: one eager warm-up tick first
            wall, (plants, _, _, obs, labels) = self.counted(
                f"{label} round {r} collect", run,
                want(ticks + int(r == 0)))
            self.check_trace(f"{label} round {r}", m, trace,
                             setup.z_band if r == 0 else None)
            buf_obs.append(obs)
            buf_lab.append(labels)
            all_obs, all_lab = torch.cat(buf_obs), torch.cat(buf_lab)
            train_s, losses = [], []
            for _ in range(DISTILL["trains"]):
                idx = torch.from_numpy(rng.integers(
                    0, all_obs.shape[0], DISTILL["train_n"])).to(dev)
                t0 = time.perf_counter()
                dstate, loss = dmain.train_on(dstate, all_obs[idx],
                                              all_lab[idx])
                losses.append(float(loss))
                train_s.append(time.perf_counter() - t0)
            if not np.isfinite(losses).all():
                raise RuntimeError(f"[{label}] round {r}: loss {losses}")
            rec = dict(beta=beta, collect_seconds=wall,
                       ms_per_tick=1e3 * wall / ticks,
                       expert_labels_per_sec=S * ticks / wall,
                       train_on_seconds=train_s, losses=losses,
                       buffer_rows=int(all_obs.shape[0]),
                       label_rms=float(labels.square().mean().sqrt()))
            log(f"[{label}] round {r} (beta {beta:.3f}"
                f"{', with the capture' if r == 0 else ''}): "
                + json.dumps(rec))
            fields["rounds"].append(rec)
        if eval_ticks:
            def run_eval():
                t0 = time.perf_counter()
                out = dmain.eval_fn(dstate, plants, eval_ticks, payloads,
                                    cmds)
                torch.cuda.synchronize()
                return time.perf_counter() - t0, out

            wall, ev = self.counted(f"{label} eval", run_eval,
                                    want(eval_ticks + 1))  # + the warm-up
            self.check_trace(f"{label} eval", m, dict(
                ctrl=ev["ctrl_traj"], qpos=ev["qpos_traj"]), None)
            fields.update(action_rmse=float(ev["action_rmse"]),
                          eval_seconds=wall,
                          eval_ms_per_tick=1e3 * wall / eval_ticks,
                          eval_final_x=ev["final_x"].tolist(),
                          eval_final_z=ev["final_z"].tolist())
        steady = fields["rounds"][-1]
        fields.update(
            expert_labels_per_sec=steady["expert_labels_per_sec"],
            ms_per_collect_tick=dict(eager=e, graph=g,
                                     graph_round=steady["ms_per_tick"]),
            seconds_per_train_on=float(np.mean(
                [x for rec in fields["rounds"]
                 for x in rec["train_on_seconds"]])),
            peak_memory_mib=(torch.cuda.max_memory_allocated() - mem0)
            / 2 ** 20)
        log(f"[{label}] fields: " + json.dumps(
            {k: v for k, v in fields.items() if k != "rounds"}))
        log(f"[{label}] {nvidia_smi_line()}")
        return fields

    def bench5(self):
        """scripts/bench_suite.py:578-622 (5_distill_round) on the port."""
        torch, dev, cs = self.torch, self.dev, self.cs
        from opendog_tpu_torch.physics import State, make_state
        from opendog_tpu_torch.rl.distill import DistillConfig, make_distiller
        from opendog_tpu_torch.rl.networks import MLPActorCritic
        from opendog_tpu_torch.solvers import MPPIConfig, costs
        m, S = self.dog, BENCH5["S"]
        cost = costs.standing_cost(m, 0.065, m.key_qpos[0, 7:])
        net = MLPActorCritic(m.nq - 2 + m.nv, m.nu, hidden=(64, 64),
                             device=dev)
        dcfg = DistillConfig(num_scenarios=S, rollout_ticks=BENCH5["ticks"],
                             batch_size=64, epochs_per_round=4)
        mcfg = MPPIConfig(horizon=BENCH5["H"], num_samples=BENCH5["K"],
                          n_substeps=2, rollout_dt=0.01, engine="kernel")
        d = make_distiller(m, cost, lambda qp, qv, t: torch.cat(
            [qp[..., 2:], qv], dim=-1), net, mcfg, dcfg, plant_substeps=10,
            device=dev)
        s0 = make_state(m, "home")
        plants = State(qpos=s0.qpos[None].repeat(S, 1),
                       qvel=torch.zeros(S, m.nv, device=dev),
                       time=torch.zeros(S, device=dev))
        dstate = d.init(torch.Generator(device=dev).manual_seed(0), s0)
        dstate, plants, _ = d.round_fn(dstate, plants, 0)  # captures
        torch.cuda.synchronize()
        want = {cs.launch_key(S * BENCH5["K"], 2):
                BENCH5["H"] * dcfg.rollout_ticks,
                cs.launch_key(S, 10): dcfg.rollout_ticks}

        def run():
            t0 = time.perf_counter()
            out = d.round_fn(dstate, plants, 0)
            loss = float(out[2]["distill_loss"])
            return time.perf_counter() - t0, out, loss

        # the standing cost: one launch of its kernel a rollout step
        want_cost = {cs.cost_launch_key(S * BENCH5["K"]):
                     BENCH5["H"] * dcfg.rollout_ticks}
        dt, (dstate, plants, _), loss = self.counted("distill-bench5", run,
                                                     want, want_cost=want_cost)
        ev = d.eval_fn(dstate, plants, BENCH5["eval_ticks"])
        zs = ev["qpos_traj"][:, :, 2]
        fields = dict(
            round_seconds=dt,
            expert_labels_per_sec=S * dcfg.rollout_ticks / dt,
            distill_loss=loss,
            student_action_rmse=float(ev["action_rmse"]),
            student_upright_frac=float(((zs > 0.03) & (zs < 0.25)).float()
                                       .mean()),
            healthy=bool(np.isfinite(loss)))
        log("[distill-bench5] 5_distill_round fields: " + json.dumps(fields))
        if not fields["healthy"]:
            raise RuntimeError("[distill-bench5] non-finite loss")
        return fields

    def students(self):
        """The committed students deployed on the flat plant kernel."""
        torch, dev, cs = self.torch, self.dev, self.cs
        from opendog_tpu_torch.physics import spatial
        from opendog_tpu_torch.rl.distill_zoo import (cmd_distill_setup,
                                                      load_student,
                                                      trot_distill_setup)
        from opendog_tpu_torch.utils.cmd_tracking import segment_record
        script = script_module("torch_distill_cmd")
        grid = script.EVAL_CMDS_BY_ROBOT["go1"]
        S, out = len(grid), {}
        for run, setup_fn, cmd_dim in (
                ("runs/distill_go1", trot_distill_setup, 0),
                ("runs/distill_cmd", cmd_distill_setup, 3)):
            setup = setup_fn("go1", engine="kernel", device=dev)
            m = setup.model
            policy = load_student(os.path.join(ROOT, run, "student.msgpack"),
                                  setup, command_dim=cmd_dim)
            plant = cs.build_cuda_substep(m, m.timestep, 10, device=dev)
            rng = m.actuator_ctrlrange
            prev = torch.clamp(m.key_ctrl[0], rng[:, 0], rng[:, 1]).expand(
                S, m.nu)
            qpos = m.key_qpos[0][None].repeat(S, 1)
            qvel = torch.zeros(S, m.nv, device=dev)
            t = torch.zeros(S, device=dev)
            cmds = torch.tensor(grid, device=dev) if cmd_dim else None

            def roll():
                nonlocal qpos, qvel, t, prev
                qs, cs_ = [], []
                t0 = time.perf_counter()
                for _ in range(STUDENT_TICKS):
                    u = policy(qpos, qvel, t, prev, cmds)
                    qp, qv = plant(qpos.T.contiguous(), qvel.T.contiguous(),
                                   u.T.contiguous())
                    qpos, qvel, t, prev = qp.T, qv.T, t + 10 * m.timestep, u
                    qs.append(qpos)
                    cs_.append(u)
                torch.cuda.synchronize()
                return (time.perf_counter() - t0, torch.stack(qs),
                        torch.stack(cs_))

            wall, qs, us = self.counted(
                f"student {run}", roll,
                {cs.launch_key(S, 10): STUDENT_TICKS})
            self.check_trace(f"student {run}", m, dict(ctrl=us, qpos=qs),
                             setup.z_band)
            x = qs[-1, :, 0]
            lane = 2 if cmd_dim else 0   # the 0.5 m/s command
            log(f"[student] {run}: {STUDENT_TICKS} ticks ({wall:.3f} s), "
                f"final x {[round(v, 4) for v in x.tolist()]}")
            if not float(x[lane]) > STUDENT_MIN_X:
                raise RuntimeError(f"[student] {run}: {float(x[lane])} m is "
                                   f"not more than {STUDENT_MIN_X} m")
            rec = dict(final_x=x.tolist(), wall_s=wall)
            if cmd_dim:
                with open(os.path.join(ROOT, run, "metrics.json")) as f:
                    art = {tuple(p["cmd"]): p["mean_vx"]
                           for p in json.load(f)["per_command"]}
                q = qs.cpu().numpy()
                rows = []
                for i, c in enumerate(grid):
                    yaw = float(spatial.euler_from_quat(qs[-1, i, 3:7])[2])
                    sr = segment_record(q[:, i, :2], yaw, c)
                    rows.append(dict(cmd=c, mean_vx=sr["mean_vx_cmd_frame"],
                                     yaw_end=sr["yaw_end"],
                                     artifact_mean_vx=art.get(tuple(c))))
                log(f"[student] {run}: mean_vx per command over the second "
                    f"half of {STUDENT_TICKS} ticks on the K1 plant, beside "
                    "the artifact's record (400 ticks, the JAX package's "
                    "plant; a record, not a target): " + json.dumps(rows))
                rec["per_command"] = rows
            out[run] = rec
        return out

    # -- the application scripts (scripts/torch_*.py) ---------------------
    def scripts(self):
        """[scripts]: the turn MPC, two jump ticks and one soak segment
        through the scripts' own ``run`` functions (module docstring)."""
        torch, dev, cs = self.torch, self.dev, self.cs
        from opendog_tpu_torch.assets import load_go1
        turn, jump, soak = (script_module(f"torch_{name}") for name in
                            ("turn_mpc", "jump_mpc", "soak_cmd"))
        warm = int(dev.type == "cuda")   # a graph's eager warm-up call
        out = {}

        def timed(fn):
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            return time.perf_counter() - t0, res

        def finite(label, x):
            if not np.isfinite(x).all():
                raise RuntimeError(f"[scripts] {label}: non-finite output")

        n, cfg = SCRIPT_TURN_TICKS, turn.CONFIG
        wall, q = self.counted("scripts turn", lambda: timed(
            lambda: turn.run(self.go1, n, cfg, generator=torch.Generator(
                device=dev).manual_seed(0)).cpu().numpy()),
            {cs.launch_key(cfg["num_samples"], cfg["n_substeps"]):
             cfg["horizon"] * (n + warm),
             cs.launch_key(PLANT["K"], PLANT["n"]): n + warm})
        finite("turn", q)
        rec = turn.summarize(q, n)
        log(f"[scripts] turn: {n} ticks in {wall:.3f} s (the capture "
            f"included): " + json.dumps(rec))
        if not rec["upright"]:
            raise RuntimeError("[scripts] turn: the trunk rolled or pitched "
                               "past 0.3 rad")
        out["turn"] = dict(rec, wall_s=wall)

        mj = load_go1("jump", device=dev)
        wall, (qps, contact) = self.counted("scripts jump", lambda: timed(
            lambda: jump.run(mj, SCRIPT_JUMP_TICKS, jump.CONFIG,
                             generator=torch.Generator(
                                 device=dev).manual_seed(0))), {})
        finite("jump", qps)
        log(f"[scripts] jump: {SCRIPT_JUMP_TICKS} ticks of the op-graph "
            f"solve at K={jump.CONFIG['num_samples']}, H="
            f"{jump.CONFIG['horizon']} in {wall:.3f} s (the capture "
            f"included): "
            f"qpos[:3] {qps[-1, :3].round(4).tolist()}, paws in contact "
            f"{contact.tolist()}")
        out["jump"] = dict(wall_s=wall, final_qpos3=qps[-1, :3].tolist())

        setup, policy = soak.soak_policy(
            "go1", os.path.join(ROOT, "runs", "distill_cmd",
                                "student.msgpack"), dev)
        schedule = soak.SCHEDULE_BY_ROBOT["go1"][:1]
        n = SCRIPT_SOAK_TICKS
        wall, (xyz, quat) = self.counted("scripts soak", lambda: timed(
            lambda: soak.run(setup, policy, schedule, n)),
            {cs.launch_key(PLANT["K"], PLANT["n"]): n + warm})
        finite("soak", xyz)
        rec = soak.summarize("go1", schedule, n, xyz, quat, setup.z_band)
        seg = rec["segments"][0]
        with open(os.path.join(ROOT, "runs", "distill_cmd",
                               "soak.json")) as f:
            jax_seg = json.load(f)["segments"][0]
        log(f"[scripts] soak: segment 0 of the committed student, {n} "
            f"ticks in {wall:.3f} s: {json.dumps(seg)}; the JAX record (a "
            f"TPU's Pallas plant): {json.dumps(jax_seg)}")
        if not rec["upright_all"]:
            raise RuntimeError("[scripts] soak: the trunk left the z band")
        for key, tol in SOAK_RECORD_TOL.items():
            if not abs(seg[key] - jax_seg[key]) <= tol:
                raise RuntimeError(f"[scripts] soak: {key} {seg[key]} vs "
                                   f"the JAX record's {jax_seg[key]}")
        out["soak"] = dict(seg, wall_s=wall)
        return out

    def bench_suite(self):
        """[bench-suite]: scripts/torch_bench_suite.py's configs that no
        other phase runs, at full width, cut in repetitions only: 1 (the
        50-substep op-graph hold replayed from one CUDA graph,
        SUITE_HOLD_REPS timed calls; the suite: 40), 2b (Go1 trot MPPI at
        K=4096, SUITE_TICKS warm-up and timed graph ticks; 100 each), 4
        (the op-graph step over B=4096 OpenDOG envs, SUITE_BATCH_REPS timed
        replays; 20), 4b (K1 at 4096 x 10 from where 4 ends) and 4d (K2+K3
        at 32,768 x 10), 20 timed launches each as in the suite.  Each
        config's launches are counted; its kernels are held to their plain
        versions by the check rows "flat bench4b" and "plane_payload
        bench4d" (and 2b's by "flat distill expert" and "flat plant")."""
        torch, dev, cs = self.torch, self.dev, self.cs
        suite = script_module("torch_bench_suite")
        out = {}

        def run(key, fn, want, gate):
            t0 = time.perf_counter()
            rec = self.counted(f"bench-suite {key}", fn, want)
            recs = rec if isinstance(rec, tuple) else (rec,)
            log(f"[bench-suite] {key} in {time.perf_counter() - t0:.3f} s: "
                + json.dumps(recs[0]))
            if not recs[0][gate]:
                raise RuntimeError(f"[bench-suite] {key}: {gate} is false")
            out[key] = recs[0]
            return rec

        run("1", lambda: suite.config_1(dev, SUITE_HOLD_REPS), {}, "healthy")
        ticks = 2 * SUITE_TICKS + 1  # and the capture's eager warm-up tick
        run("2b", lambda: suite.config_2b(dev, SUITE_TICKS, kernels=False),
            {cs.launch_key(4096, ROLLOUT["n"]): 25 * ticks,
             cs.launch_key(PLANT["K"], PLANT["n"]): ticks}, "healthy")
        _, batch = run("4", lambda: suite.config_4(dev, SUITE_BATCH_REPS),
                       {}, "all_finite")
        launches = SUITE_FUSED_REPS + 1  # and the warm-up launch
        run("4b", lambda: suite.config_4b(dev, batch, SUITE_FUSED_REPS,
                                          kernels=False),
            {cs.launch_key(BATCH["K"], BATCH["n"]): launches},
            "all_finite")
        run("4d", lambda: suite.config_4d(dev, SUITE_FUSED_REPS,
                                          kernels=False),
            {cs.launch_key(BENCH_4D["K"], BENCH_4D["n"], True, True):
             launches}, "all_finite")
        log(f"[bench-suite] config 4's peak memory "
            f"{out['4'].get('peak_memory_gib', 0.0):.2f} GiB, capture "
            f"{out['4']['capture_s']:.3f} s; config 1's capture "
            f"{out['1']['capture_s']:.3f} s ({nvidia_smi_line()})")
        return out

    # -- the robot bridge over the wire (apps/mpc_bridge.py) -------------
    def twin_check(self, model):
        """The DigitalTwin on the card: its advance replayed from a CUDA
        graph on its own stream equals the eager op-graph step bit for bit
        on the same angles; then the advance timed alone (host blocking
        time of ``mirror_once`` + ``snapshot``, and CUDA events on the
        twin's stream)."""
        torch, dev = self.torch, self.dev
        from opendog_tpu_torch.physics import dynamics, make_state
        from opendog_tpu_torch.sim2real.twin import DigitalTwin
        twin = DigitalTwin(model, device=dev)
        cal = twin.cal
        rng = np.random.default_rng(7)
        angles = cal.real_home_deg + rng.uniform(
            -10, 10, (TWIN_EQ_TICKS + TWIN_TICKS, 8)).astype(np.float32)
        st = make_state(twin.model, "home")
        t0 = time.perf_counter()
        for a in angles[:TWIN_EQ_TICKS]:
            st, _ = dynamics.step(twin.model, st, twin.real_angles_to_ctrl(a),
                                  n_substeps=10)
            twin.mirror_once(a, substeps=10)
            g = twin.snapshot()  # read on the twin's stream
            for k in ("qpos", "qvel", "time"):
                e = getattr(st, k).cpu()
                if not torch.equal(e, getattr(g, k)):
                    d = (e - getattr(g, k)).abs().max().item()
                    raise RuntimeError(f"[mpc-bridge] the twin's graph "
                                       f"differs from eager on {k}: {d}")
        log(f"[mpc-bridge] twin: graph (own stream) vs eager over "
            f"{TWIN_EQ_TICKS} advances of 10 substeps on the same angles: "
            f"qpos, qvel, time equal bit for bit "
            f"({time.perf_counter() - t0:.3f} s with the capture)")
        # alone, replayed in turns on the twin's own stream and on the
        # default stream
        streams = {"own": twin._stream,
                   "default": torch.cuda.current_stream(dev)}
        host = {k: [] for k in streams}
        dev_ms = {k: [] for k in streams}
        for i, a in enumerate(angles[TWIN_EQ_TICKS:]):
            side = ("own", "default")[i % 2]
            twin._stream = streams[side]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record(twin._stream)
            twin.mirror_once(a, substeps=10)
            end.record(twin._stream)
            twin.snapshot()
            host[side].append(time.perf_counter() - t0)
            end.synchronize()
            dev_ms[side].append(start.elapsed_time(end))
        twin._stream = streams["own"]
        fields = {f"{side}_stream": dict(
            host_ms_median=1e3 * float(np.median(host[side])),
            host_ms_p99=1e3 * float(np.percentile(host[side], 99)),
            device_ms_median=float(np.median(dev_ms[side])))
            for side in streams}
        fields["nodes"] = graph_nodes(twin._graphs[10].graph)
        log(f"[mpc-bridge] twin advance (10 op-graph substeps, one graph "
            f"replay) + snapshot, {TWIN_TICKS} alone, in turns on its own "
            f"and on the default stream: " + json.dumps(fields))
        return fields

    def mpc_bridge(self):
        """make_bridge (OpenDOG trot MPPI on K1, K=256, H=25, 2 x 10 ms)
        against two firmware simulators built from native/ and spawned on
        loopback: a plain and a compensated arm, each primed off the clock
        and run for BRIDGE["ticks"] paced 50 Hz ticks; then a plain arm of
        STREAM_AB_TICKS whose twin replays on its own stream and on the
        default stream (the controller's) in turns, tick by tick."""
        torch, dev, cs = self.torch, self.dev, self.cs
        from opendog_tpu_torch.apps.mpc_bridge import make_bridge
        from opendog_tpu_torch.native import build as native
        from opendog_tpu_torch.sdk import QuadPilotBody
        t0 = time.perf_counter()
        binary = native.build("firmware_sim")
        log(f"[mpc-bridge] firmware_sim ({binary}) ready in "
            f"{time.perf_counter() - t0:.2f} s")
        out = dict(twin=self.twin_check(self.dog))
        lag, n = BRIDGE["lag"], BRIDGE["ticks"]
        p1, p2 = BRIDGE_PORT + 1, BRIDGE_PORT + 2
        with native.firmware_pair(p1, p2, BRIDGE_PORT):
            for arm in ("plain", "compensated", "stream-ab"):
                body = QuadPilotBody(ip1="127.0.0.1", ip2="127.0.0.1",
                                     port1=p1, port2=p2,
                                     listen_for_broadcasts=True,
                                     listen_port=BRIDGE_PORT)
                try:
                    out[arm] = self.bridge_arm(
                        arm, body, make_bridge(
                            body, lag=lag, num_samples=BRIDGE["samples"],
                            engine="kernel", compensate=arm == "compensated",
                            device=dev))
                finally:
                    body.close()
        return out

    def bridge_arm(self, arm, body, bridge):
        """One arm of [mpc-bridge]: bring-up over the wire, priming ticks
        (the captures), the paced run with its launches counted, a time
        breakdown of each tick (twin estimate, bridge_tick, set_angles) and
        the gates."""
        torch, cs = self.torch, self.cs
        label = f"mpc-bridge {arm}"
        lag = bridge.controller.lag
        if not bridge.bring_up(settle_s=1.0):
            raise RuntimeError(f"[{label}] bring-up not ACKed by the firmware")
        deadline = time.time() + 3.0
        while not (body.is_data_available_from_esp(0)
                   and body.is_data_available_from_esp(1)):
            if time.time() > deadline:
                raise RuntimeError(f"[{label}] no telemetry from the firmware")
            time.sleep(0.05)
        t0 = time.perf_counter()
        for _ in range(lag + 2):  # captures the solve and the twin's advance
            bridge.tick()
            time.sleep(TICK_S)
        log(f"[{label}] {lag + 2} priming ticks (with the captures) in "
            f"{time.perf_counter() - t0:.3f} s")
        parts = {"estimate": [], "bridge_tick": [], "set_angles": []}

        def timed(name, fn):
            def call(*a, **kw):
                t = time.perf_counter()
                r = fn(*a, **kw)
                parts[name].append(time.perf_counter() - t)
                return r
            return call

        if arm == "stream-ab":
            # the twin's replay in turns on its own stream and queued on
            # the controller's (default) stream, behind the solve in flight
            twin = bridge.twin
            streams = (twin._stream, torch.cuda.current_stream(self.dev))
            parts = {"estimate own stream": [],
                     "estimate default stream": [], "bridge_tick": [],
                     "set_angles": []}
            estimate, calls = bridge._estimate_state, [0]

            def alternating():
                side = calls[0] % 2
                calls[0] += 1
                twin._stream = streams[side]
                return timed(("estimate own stream",
                              "estimate default stream")[side], estimate)()

            bridge._estimate_state = alternating
        else:
            bridge._estimate_state = timed("estimate",
                                           bridge._estimate_state)
        bridge.controller.bridge_tick = timed("bridge_tick",
                                              bridge.controller.bridge_tick)
        body.set_angles = timed("set_angles", body.set_angles)
        n = STREAM_AB_TICKS if arm == "stream-ab" else BRIDGE["ticks"]
        cfg = bridge.controller._config
        want = {cs.launch_key(cfg.num_samples, cfg.n_substeps):
                cfg.horizon * n}
        if bridge.controller.compensate:  # the predictor: K=1 x10 per lag
            want[cs.launch_key(1, bridge.controller._plant_substeps)] = \
                lag * n
        rows = ["flat bridge rollout"] + (
            ["flat bridge predictor"] if bridge.controller.compensate else [])
        m = self.counted(label, lambda: bridge.run(n, rate_hz=1 / TICK_S),
                         want, rows=rows)
        m["parts_ms"] = {k: dict(median=1e3 * float(np.median(v)),
                                 p99=1e3 * float(np.percentile(v, 99)),
                                 max=1e3 * float(np.max(v)))
                         for k, v in parts.items()}
        log(f"[{label}] {n} ticks paced at {TICK_S * 1e3:.0f} ms: "
            + json.dumps(m))
        numbers = [v for v in m.values() if isinstance(v, (int, float))]
        if not np.isfinite(numbers).all():
            raise RuntimeError(f"[{label}] a metric is not finite: {m}")
        if not m["twin_healthy"]:
            raise RuntimeError(f"[{label}] the twin is not healthy: {m}")
        if not m["joint_track_rmse_deg"] < BRIDGE_RMSE_DEG:
            raise RuntimeError(f"[{label}] joint tracking RMSE "
                               f"{m['joint_track_rmse_deg']} deg is not under "
                               f"{BRIDGE_RMSE_DEG}")
        return m

    def student_bridge(self):
        """scripts/torch_cmd_student_bridge.py --smoke on the card: the
        committed OpenDOG command student (runs/distill_cmd_opendog) through
        StudentBridge.run_segments at 50 Hz against its own firmware pair.
        Before it, the student's CUDA graph (StudentBridge.act) against
        its eager policy bit for bit on 3 random states and commands.
        Gates upright_all; prints the other summary booleans."""
        torch, dev = self.torch, self.dev
        from opendog_tpu_torch.apps.mpc_bridge import StudentBridge
        from opendog_tpu_torch.rl.distill_zoo import (cmd_distill_setup,
                                                      load_student)
        setup = cmd_distill_setup("opendog", engine="kernel", device=dev)
        m = setup.model
        policy = load_student(os.path.join(
            ROOT, "runs", "distill_cmd_opendog", "student.msgpack"), setup,
            command_dim=3)
        sb = StudentBridge(m, policy, None, device=dev)
        rng = np.random.default_rng(8)
        for i in range(3):
            q = m.numpy("key_qpos")[0] + rng.normal(0, 0.02, m.nq)
            v = rng.normal(0, 0.2, m.nv)
            t = 0.02 * (i + 1)
            sb._prev = sb._prev + rng.normal(0, 0.05, m.nu).astype(
                np.float32)
            sb.set_command(rng.uniform(-0.2, 0.2, 3))
            got = sb.act(q, v, t)
            want = policy(*(torch.as_tensor(np.asarray(a, np.float32)[None],
                                            device=dev)
                            for a in (q, v, t, sb._prev, sb.cmd)))
            want = want[0].cpu().numpy()
            if not np.array_equal(got, want):
                raise RuntimeError(f"[student-bridge] the policy's graph "
                                   f"differs from eager: "
                                   f"{np.abs(got - want).max()}")
        log("[student-bridge] the student's CUDA graph equals its eager "
            "policy bit for bit on 3 random states and commands")
        script = script_module("torch_cmd_student_bridge")
        out = self.counted("student-bridge", lambda: script.run(
            os.path.join(ROOT, "runs", "distill_cmd_opendog"),
            STUDENT_BRIDGE_PORT, STUDENT_BRIDGE_T, (50.0,), device=self.dev,
            log=lambda s: log(f"[student-bridge] {s}")), {})
        log("[student-bridge] summary: " + json.dumps(out["summary"]))
        if not out["summary"]["upright_all"]:
            raise RuntimeError("[student-bridge] a segment fell: "
                               + json.dumps(out["rate_50hz"]["segments"]))
        return dict({k: v for k, v in out["rate_50hz"].items()
                     if k != "segments"}, summary=out["summary"])

    def gait_replay(self):
        """sim2real/gait_designer.py on the card: a 130-substep row replayed
        from the 128-substep and 1-substep graphs equals the eager op-graph
        step bit for bit; then the full design_trot (12 swing steps, 6.8 s
        of robot time) through replay_gait: finite, trunk above
        GAIT_Z_MIN."""
        torch, dev = self.torch, self.dev
        from opendog_tpu_torch.physics import dynamics, make_state
        from opendog_tpu_torch.sim2real import gait_designer as gd
        m = self.dog
        d, sim, _ = gd.design_trot(m)
        row = sim[1:2]
        got = gd.replay_gait(m, [GAIT_EQ_SUBSTEPS * m.timestep], row,
                             settle_steps=2, device=dev)
        inv = np.argsort(gd.Calibration(m).model_actuator_index)
        ctrl = torch.from_numpy(row[0, inv].copy()).to(dev)
        st = make_state(m, "home")
        st, _ = dynamics.step(m, st, m.key_ctrl[0], None, n_substeps=2)
        for _ in range(GAIT_EQ_SUBSTEPS):
            st, _ = dynamics.step(m, st, ctrl, n_substeps=1)
        eager = st.qpos[:7].cpu().numpy()
        if not np.array_equal(got["trunk"][0], eager):
            raise RuntimeError(f"[gait-replay] graphs differ from eager: "
                               f"{np.abs(got['trunk'][0] - eager).max()}")
        log(f"[gait-replay] {GAIT_EQ_SUBSTEPS} substeps from the 128- and "
            "1-substep graphs equal eager bit for bit")

        def run():
            t0 = time.perf_counter()
            r = gd.replay_gait(m, d, sim, device=dev)
            return r, time.perf_counter() - t0

        res, wall = self.counted("gait-replay", run, {})
        trunk = res["trunk"]
        fields = dict(seconds=wall, rows=len(d), robot_seconds=float(sum(d)),
                      trunk_z_min=float(trunk[:, 2].min()),
                      final_x=float(trunk[-1, 0]),
                      max_joint_err=float(res["max_joint_err"].max()))
        log("[gait-replay] design_trot replayed: " + json.dumps(fields))
        if not (np.isfinite(trunk).all()
                and np.isfinite(res["max_joint_err"]).all()):
            raise RuntimeError("[gait-replay] non-finite trunk or error")
        if not fields["trunk_z_min"] > GAIT_Z_MIN:
            raise RuntimeError(f"[gait-replay] trunk z {fields['trunk_z_min']}"
                               f" is not above {GAIT_Z_MIN}")
        return fields

    # -- perception -----------------------------------------------------
    def perception(self):
        """apps/slam.py, mapping.py, obstacle.py and mono_depth.py on the
        card (module docstring, [perception]); runs no substep kernel."""
        out = self.counted("perception", self.perception_run, {})
        log("[perception] " + json.dumps(out))
        return out

    def perception_check(self, label, err, tol):
        log(f"[perception] card vs CPU {label}: max abs err {err:.3e} "
            f"(tolerance {tol:.0e})")
        if not err <= tol:
            raise RuntimeError(f"[perception] card vs CPU {label}: {err} > "
                               f"{tol}")
        return err

    def perception_run(self):
        torch, dev = self.torch, self.dev
        from opendog_tpu_torch.apps import mapping, mono_depth, obstacle, slam
        from opendog_tpu_torch.physics import terrain as terrain_lib
        from opendog_tpu_torch.utils.profiling import event_ms
        m, terr = self.dog_t, self.terrain
        mc, terr_c = m.to("cpu"), terr.to("cpu")
        tol, smi = PERCEPTION_TOL, nvidia_smi_line()
        relief = float(terr.height.max() - terr.height.min())
        if not relief > 0.05:
            raise RuntimeError(f"[perception] terrain relief {relief} m")
        out = dict(terrain_relief_m=relief, card_vs_cpu={})
        errs = out["card_vs_cpu"]

        # the card against the CPU on the same inputs
        poses = torch.tensor(PERCEPTION_POSES)
        want = slam.render_depth(mc, terr_c, poses)
        got = slam.render_depth(m, terr, poses.to(dev)).cpu()
        for i, p in enumerate(PERCEPTION_POSES):
            one = slam.render_depth(m, terr, p).cpu()
            if not torch.equal(one.nan_to_num(9.0), got[i].nan_to_num(9.0)):
                raise RuntimeError("[perception] render_depth of one pose "
                                   "differs from its row of the batch")
        if not torch.equal(torch.isnan(got), torch.isnan(want)):
            raise RuntimeError("[perception] render_depth NaN masks differ")
        fin = torch.isfinite(want)
        hit = float(fin.all(-1).float().mean())
        if not hit > 0.8:
            raise RuntimeError(f"[perception] only {hit} of the rays hit")
        errs["render_depth_m"] = self.perception_check(
            "render_depth", float((got[fin] - want[fin]).abs().max()),
            tol["render_m"])
        rng = np.random.default_rng(0)
        frame = (want[1].numpy() + rng.normal(0, 0.01, want[1].shape)
                 ).astype(np.float32)
        pose0 = np.array(PERCEPTION_POSES[1], np.float32) + np.array(
            [0.12, -0.08, 0.06], np.float32)
        pc, rc = slam.point_to_plane_icp(mc, terr_c, torch.from_numpy(frame),
                                         pose0)
        pg, rg = slam.point_to_plane_icp(m, terr, torch.from_numpy(
            frame).to(dev), pose0)
        errs["icp_pose"] = self.perception_check(
            "ICP pose", float((pg.cpu() - pc).abs().max()), tol["icp"])
        errs["icp_rms"] = self.perception_check(
            "ICP rms", abs(float(rg) - float(rc)), tol["icp"])
        draws = terrain_lib.draw_terrain_fractal(
            mc, torch.Generator().manual_seed(200))
        hc = terrain_lib.generate_terrain_fractal(mc, draws=draws).height
        hg = terrain_lib.generate_terrain_fractal(m, draws=type(draws)(
            *(f.to(dev) for f in draws))).height
        errs["fractal_m"] = self.perception_check(
            "fractal heights", float((hg.cpu() - hc).abs().max()),
            tol["fractal_m"])
        net = mono_depth.DepthCNN(generator=torch.Generator().manual_seed(0))
        x = torch.from_numpy(rng.uniform(0, 1, (48, 1, 24, 32)).astype(
            np.float32))
        with torch.no_grad():
            yc = net(x)
            yg = net.to(dev)(x.to(dev)).cpu()
        errs["depth_cnn_m"] = self.perception_check(
            "DepthCNN forward", float((yg - yc).abs().max()), tol["cnn_m"])

        # localization: the 40-step walk on the card
        frames = []
        t0 = time.perf_counter()
        walk = slam.simulate_walk_localization(m, terr, n_steps=WALK_STEPS,
                                               frames=frames)
        walk["seconds"] = time.perf_counter() - t0
        out["walk"] = walk
        log("[perception] walk: " + json.dumps(walk))
        if not (walk["icp_beats_deadreckon"]
                and walk["icp_rmse_m"] < 0.5 * walk["deadreckon_rmse_m"]
                and walk["icp_final_err_m"] < WALK_FINAL_ERR_M):
            raise RuntimeError(f"[perception] walk gates failed: {walk}")

        # the walk's frames into a voxel map; one frame's obstacles
        vg = mapping.VoxelMap(device=dev)
        vc = mapping.VoxelMap(device="cpu")
        for pose, f in frames:
            world = mapping.transform_points(torch.from_numpy(f).to(dev),
                                             pose)
            vg = vg.integrate(world)
            vc = vc.integrate(world.cpu())
        if not torch.equal(vg.counts.cpu(), vc.counts):
            raise RuntimeError("[perception] VoxelMap counts differ from "
                               "the CPU's")
        f = torch.from_numpy(frames[-1][1])
        cg, ng = obstacle.detect_obstacles(f.to(dev))
        cc, nc = obstacle.detect_obstacles(f)
        if not (torch.equal(ng.cpu(), nc) and torch.equal(
                cg.cpu().nan_to_num(9.0), cc.nan_to_num(9.0))):
            raise RuntimeError("[perception] detect_obstacles differs from "
                               "the CPU's")
        avoider = obstacle.ObstacleAvoider()
        avoider.start(0.0)
        target = avoider.update(cg.cpu().numpy(), 0.0)
        occupied = int((ng >= 5).sum())
        if not (np.isfinite(target) and np.isfinite(vg.occupied(3)).all()):
            raise RuntimeError("[perception] map or avoider not finite")
        out["map"] = dict(points=int(vg.counts.sum()),
                          occupied_voxels=len(vg.occupied(3)),
                          obstacle_cells=occupied, avoid_state=
                          avoider.state.value, target_yaw_deg=target)
        log("[perception] map and obstacles: " + json.dumps(out["map"]))

        # the depth net: train, then the three cross-family arms
        terrains = [terrain_lib.generate_terrain(
            m, torch.Generator().manual_seed(s)) for s in range(4)]
        t0 = time.perf_counter()
        dnet, train = mono_depth.train_depth_net(m, terrains, device=dev,
                                                 **DEPTH_TRAIN)
        torch.cuda.synchronize()
        train["seconds"] = time.perf_counter() - t0
        fam2 = [terrain_lib.generate_terrain_fractal(
            m, generator=torch.Generator().manual_seed(s))
            for s in range(200, 204)]
        arms = dict(
            fam2_terrain=(fam2, mono_depth.render_shaded, 8000),
            fam2_renderer=(terrains, mono_depth.render_shaded_overcast,
                           9000),
            fam2_both=(fam2, mono_depth.render_shaded_overcast, 10000))
        depth = dict(train=train)
        for name, (ts, renderer, seed) in arms.items():
            depth[name] = mono_depth.eval_depth_arm(
                m, dnet, ts, DEPTH_EVAL_FRAMES, seed, renderer=renderer)
        out["depth"] = depth
        log("[perception] depth net: " + json.dumps(depth))
        if not (all(a["beats_baseline"] for a in depth.values())
                and train["val_rmse_m"]
                < 0.5 * train["mean_depth_baseline_rmse_m"]):
            raise RuntimeError(f"[perception] depth gates failed: {depth}")

        # timings
        pose = torch.tensor(PERCEPTION_POSES[0], device=dev)
        render_ms = event_ms(lambda: slam.render_depth(m, terr, pose),
                             PERCEPTION_REPS)
        loc = slam.TerrainLocalizer(m, terr)
        loc.update(0.25, 0.0, 0.0, 0.1, frame)      # warm-up
        t0 = time.perf_counter()
        for _ in range(PERCEPTION_REPS):
            loc.pose = pose0.copy()
            loc.update(0.0, 0.0, float(np.degrees(pose0[2])), 0.1, frame)
        update_ms = (time.perf_counter() - t0) / PERCEPTION_REPS * 1e3
        opt = torch.optim.Adam(dnet.parameters(), lr=3e-3)
        xb = torch.from_numpy(rng.uniform(0, 1, (16, 1, 24, 32)).astype(
            np.float32)).to(dev)
        yb = torch.from_numpy(rng.uniform(0.3, 4, (16, 24, 32)).astype(
            np.float32)).to(dev)

        def adam_step():
            opt.zero_grad(set_to_none=True)
            torch.mean((dnet(xb) - yb) ** 2).backward()
            opt.step()

        adam_ms = event_ms(adam_step, PERCEPTION_REPS)
        times = dict(render_depth_ms_per_frame=render_ms,
                     localizer_update_ms=update_ms, adam_step_ms=adam_ms,
                     train_depth_net_s=train["seconds"],
                     walk_s=walk["seconds"])
        for k, v in times.items():
            log(f"[perception] {k} {v:.4f} ({smi})")
        out["times"] = times
        return out

    # -- the rest of the package (ROADMAP M15c) --------------------------
    def apps(self):
        """[apps]: the viewer, voice, cloning and nnvis on the card (module
        docstring); runs no substep kernel."""
        def run():
            t0 = time.perf_counter()
            out = dict(viewer=self.viewer_check(),
                       voice=self.voice_check(),
                       cloning=self.cloning_check())
            out["seconds"] = time.perf_counter() - t0
            return out

        out = self.counted("apps", run, {})
        log("[apps] " + json.dumps(out))
        return out

    def viewer_pair(self, label, card, cpu, n):
        """``n`` ticks of the card's viewer and of the CPU's; their states'
        max abs differences, gated at the CPU check's tolerance."""
        a, b = card.step_once(n), cpu.step_once(n)
        err = {f: float((getattr(a, f) - getattr(b, f)).abs().max())
               for f in ("qpos", "qvel")}
        log(f"[apps] viewer {label}: card vs CPU max abs err {err}")
        if not (err["qpos"] <= CPU_CHECK_TOL["qpos"]
                and err["qvel"] <= CPU_CHECK_TOL["qvel"]
                and bool(self.torch.isfinite(a.qpos).all())):
            raise RuntimeError(f"[apps] viewer {label}: card vs CPU {err}")
        return a, err

    def viewer_check(self):
        torch, dev = self.torch, self.dev
        from opendog_tpu_torch.apps.viewer_cli import build_viewer
        from opendog_tpu_torch.telemetry import TelemetryClient
        card = build_viewer("opendog", device=dev)
        eager = build_viewer("opendog", device=dev, graphs=False)
        cpu = build_viewer("opendog", device="cpu")
        out = {}
        client = None
        try:
            for v in (card, eager, cpu):
                v.pause()
            # replayed ticks against eager ticks on the card, bit for bit
            t0 = time.perf_counter()
            b = eager.step_once(VIEWER_EQ_TICKS)
            out["eager_ms_per_tick"] = (time.perf_counter() - t0) * 1e3 / \
                VIEWER_EQ_TICKS
            t0 = time.perf_counter()
            a = card.step_once(VIEWER_EQ_TICKS)
            out["capture_s"] = time.perf_counter() - t0
            if not (all(torch.equal(getattr(a, f), getattr(b, f))
                         for f in ("qpos", "qvel", "time"))
                    and card._packet() == eager._packet()):
                raise RuntimeError("[apps] viewer: the replayed ticks differ "
                                   "from the eager ticks")
            out["graph_nodes"] = graph_nodes(card._graph.graph)
            log(f"[apps] viewer: {VIEWER_EQ_TICKS} ticks replayed from one "
                f"CUDA graph ({out['graph_nodes']} nodes) equal "
                f"{VIEWER_EQ_TICKS} eager ticks bit for bit")
            cpu.step_once(VIEWER_EQ_TICKS)
            _, out["ticks_err"] = self.viewer_pair(
                f"{VIEWER_TICKS} ticks", card, cpu,
                VIEWER_TICKS - VIEWER_EQ_TICKS)
            for v in (card, cpu):
                v.apply_wrench(force=(8.0, 0.0, 0.0), duration_s=v.period)
            a, out["push_err"] = self.viewer_pair("push tick", card, cpu, 1)
            q = a.qpos.clone()
            q[2] = 0.3
            for v in (card, cpu):
                v.set_state(qpos=q.numpy())
            if not torch.equal(card.snapshot().qpos, q):
                raise RuntimeError("[apps] viewer: set_state did not set qpos")
            _, out["set_state_err"] = self.viewer_pair(
                "tick after set_state", card, cpu, 1)
            # ms per replayed tick: CUDA events on the viewer's stream
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(card._stream)
            card.step_once(VIEWER_TIMED_TICKS)
            end.record(card._stream)
            end.synchronize()
            out["graph_ms_per_tick"] = start.elapsed_time(end) / \
                VIEWER_TIMED_TICKS
            log(f"[apps] viewer: {out['graph_ms_per_tick']:.4f} ms per "
                f"replayed tick (events); the first {VIEWER_EQ_TICKS} eager "
                f"ticks {out['eager_ms_per_tick']:.1f} ms each (host clock, "
                f"first calls included) ({nvidia_smi_line()})")
            # the telemetry stream of the launched (paused) viewer
            card.launch()
            client = TelemetryClient("127.0.0.1", card.server.port,
                                     timeout=0.5)
            snap = card.snapshot().qpos.numpy()[:7]
            pkts = []
            deadline = time.time() + 20.0
            while len(pkts) < 3 and time.time() < deadline:
                if not pkts:
                    client.connect()
                p = client.recv()
                if p is not None:
                    pkts.append(p)
            keys = {"time", "qpos", "qvel", "ctrl", "contact_forces", "ncon"}
            if len(pkts) < 3 or any(set(p) != keys for p in pkts):
                raise RuntimeError(f"[apps] telemetry: {len(pkts)} packets "
                                   f"{[sorted(p) for p in pkts]}")
            err = max(float(np.abs(np.asarray(p["qpos"]) - snap).max())
                      for p in pkts)
            if not err <= TELEMETRY_TOL:
                raise RuntimeError(f"[apps] telemetry qpos vs snapshot {err}")
            out["telemetry"] = dict(packets=len(pkts), qpos_err=err,
                                    ncon=pkts[-1]["ncon"])
            log(f"[apps] telemetry: {len(pkts)} packets read back on "
                f"loopback, qpos within {err:.2e} of the snapshot")
        finally:
            if client is not None:
                client.close()
            for v in (card, eager, cpu):
                v.close()
        return out

    def voice_check(self):
        torch, dev = self.torch, self.dev
        from opendog_tpu_torch.apps import voice, voice_frontend as vf
        from opendog_tpu_torch.utils.profiling import event_ms
        card, cpu = vf.KeywordSpotter(device=dev), vf.KeywordSpotter(
            device="cpu")
        err = max(float(np.abs(a - b).max()) for w in vf.VOCABULARY
                  for a, b in zip(card.templates[w], cpu.templates[w]))
        log(f"[apps] voice: templates card vs CPU max abs err {err:.3e}")
        if not err <= VOICE_TOL:
            raise RuntimeError(f"[apps] voice templates: {err} > {VOICE_TOL}")
        for w in vf.VOCABULARY:
            for f0, rate, noise, seed in VOICE_SPEAKERS:
                got, score = card.classify(vf.synthesize_word(
                    w, f0=f0, rate=rate, noise=noise, seed=seed))
                if got != w:
                    raise RuntimeError(f"[apps] voice: {w} at f0 {f0} -> "
                                       f"{got} ({score})")
        transcripts = {}
        for words, kw, command in VOICE_PHRASES:
            audio = vf.synthesize_phrase(list(words), **kw)
            text = card.transcribe(audio)
            cmd = voice.parse_command(text)
            if text != cpu.transcribe(audio) or cmd is None \
                    or cmd.value != command:
                raise RuntimeError(f"[apps] voice: {words} -> {text!r} "
                                   f"({cmd}) on the card")
            transcripts[" ".join(words)] = text
        clip = vf.synthesize_word("izquierda", f0=125.0, noise=0.02, seed=1)
        ms = event_ms(lambda: vf.log_mel(clip, device=dev),
                      VOICE_REPS)
        log(f"[apps] voice: {2 * len(vf.VOCABULARY)} words and "
            f"{len(transcripts)} phrases right; {ms:.4f} ms per log_mel "
            f"({nvidia_smi_line()})")
        return dict(template_err=err, transcripts=transcripts,
                    log_mel_ms=ms)

    def cloning_check(self):
        import copy
        torch, dev = self.torch, self.dev
        from opendog_tpu_torch.apps import cloning, nnvis
        from opendog_tpu_torch.rl.networks import (COMMITTED_WALK_POLICY,
                                                   load_flax_params,
                                                   read_npz_tree)
        from opendog_tpu_torch.train import build
        draws = torch.rand((CLONING_EQ_STEPS, 256, 1), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(
                               1)) * 60.0 - 30.0
        graph, eager = (cloning.train_cloned_policy(
            draws=draws, num_steps=CLONING_EQ_STEPS, device=dev,
            generator=torch.Generator(device=dev).manual_seed(0),
            graphs=graphs) for graphs in (True, False))
        if not all(torch.equal(a, b) for a, b in zip(graph.parameters(),
                                                    eager.parameters())):
            raise RuntimeError("[apps] cloning: the replayed steps differ "
                               "from the eager steps")
        t0 = time.perf_counter()
        net = cloning.train_cloned_policy(
            generator=torch.Generator(device=dev).manual_seed(0), device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        err = 0.0
        for e in (-20.0, -5.0, 0.0, 5.0, 20.0):
            got = cloning.cloned_lift_angles(net, e)
            want = cloning.expert_action(e).numpy()
            err = max(err, float(abs(got[0] - want[0])),
                      float(abs(got[1] - want[1])))
        log(f"[apps] cloning: {CLONING_EQ_STEPS} steps replayed from a CUDA "
            "graph equal the eager steps bit for bit; 2000 Adam steps (1 "
            f"eager, 1999 replayed) in {seconds:.3f} s, "
            f"{err:.3f} degrees from the expert at most "
            f"({nvidia_smi_line()})")
        if not err < CLONING_BAND_DEG:
            raise RuntimeError(f"[apps] cloning: {err} degrees from the "
                               "expert")
        _, _, policy = build("walk", dev)
        load_flax_params(policy, read_npz_tree(COMMITTED_WALK_POLICY))
        obs = np.random.default_rng(0).normal(
            size=(64, policy.obs_dim)).astype(np.float32)
        a = nnvis.capture_activations(policy, torch.from_numpy(obs).to(dev))
        b = nnvis.capture_activations(copy.deepcopy(policy).to("cpu"),
                                      torch.from_numpy(obs))
        if set(a) != set(b):
            raise RuntimeError(f"[apps] nnvis: keys {sorted(a)} vs "
                               f"{sorted(b)}")
        act_err = 0.0
        for k in b:
            k_err = float(np.abs(a[k] - b[k]).max())
            tol = NNVIS_TOL + 4 * float(np.finfo(np.float32).eps) * float(
                np.abs(b[k]).max())
            if not k_err <= tol:
                raise RuntimeError(f"[apps] nnvis {k}: card vs CPU {k_err} "
                                   f"> {tol}")
            act_err = max(act_err, k_err)
        log(f"[apps] nnvis: {len(a)} activations of the walk policy, card "
            f"vs CPU max abs err {act_err:.3e}")
        return dict(train_s=seconds, max_err_deg=err, nnvis_keys=sorted(a),
                    nnvis_err=act_err)

    # -- PPO training ---------------------------------------------------
    def ppo_graph(self):
        """[ppo-graph]: the rollout step replayed from its CUDA graph equals
        the eager step bit for bit for PPO_EQ_STEPS steps on the same draws,
        for walk, sym and terrain at 16 envs; eager ms per step."""
        out = {}
        for task in PPO_EQ_TASKS:
            pair = ppo_rollout_pair(self.torch, self.dev, task,
                                    PPO_WALK["n_envs"], PPO_EQ_STEPS)
            bad, n = ppo_pair_differences(self.torch, pair)
            if bad:
                raise RuntimeError(f"[ppo-graph] {task}: graph != eager in "
                                   f"{bad}")
            ms = pair[False]["rollout_s"] / PPO_EQ_STEPS * 1e3
            out[task] = dict(eager_ms_per_step=ms, fields_equal=n)
            log(f"[ppo-graph] {task}: {n} fields (trajectory, env state, "
                f"observations) equal bit for bit over {PPO_EQ_STEPS} steps "
                f"x {PPO_WALK['n_envs']} envs; eager {ms:.3f} ms per step "
                f"(the graph side includes its capture: "
                f"{pair[True]['rollout_s']:.3f} s)")
        return out

    def ppo_train(self, label, task, chunks, eval_steps=0, save_interval=0,
                  **kw):
        """``train(task)`` on the card through the CLI's entry point, from
        a fresh run directory: per-chunk rollout / update seconds and
        env-steps/s from its metrics, peak memory; gates: finite metrics,
        ``update_count == chunks``, the parameters moved."""
        torch, dev = self.torch, self.dev
        import shutil
        from opendog_tpu_torch.rl.ppo import PPOConfig, make_ppo
        from opendog_tpu_torch.train import TASKS, build, train
        out_dir = os.path.join(PPO_OUT, label)
        run = os.path.join(out_dir, f"{task}_0")
        shutil.rmtree(run, ignore_errors=True)
        cfg = dict(PPO_WALK, **kw)
        _, env, net = build(task, dev)
        init, _ = make_ppo(env, net, PPOConfig(
            num_envs=cfg["n_envs"], loss=TASKS[task]["loss"]), dev,
            graphs=False)
        p0 = init(torch.Generator(device=dev).manual_seed(0)).params
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        state = train(task, total_chunks=chunks, out_dir=out_dir, seed=0,
                      save_interval=save_interval or chunks,
                      eval_interval=chunks if eval_steps else 0,
                      video_interval=0, eval_steps=eval_steps or 1,
                      device=dev, **cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        rows = read_metrics(run)
        trains = [r for r in rows if "train/mean_reward" in r]
        evals = [r for r in rows if "eval/episode_return" in r]
        bad = [k for r in rows for k, v in r.items()
               if isinstance(v, float) and not np.isfinite(v)]
        if bad or len(trains) != chunks:
            raise RuntimeError(f"[{label}] metrics not finite {bad} or "
                               f"{len(trains)} chunks")
        if state.update_count != chunks:
            raise RuntimeError(f"[{label}] update_count "
                               f"{state.update_count}")
        moved = max(float((state.params[k] - p0[k]).detach().abs().max())
                    for k in p0)
        if not moved > 0:
            raise RuntimeError(f"[{label}] the parameters did not move")
        T = cfg["n_steps"]
        rec = dict(
            task=task, n_envs=cfg["n_envs"], n_steps=T,
            hidden=list(TASKS[task]["hidden"]), loss=TASKS[task]["loss"],
            chunks=chunks, wall_s=wall, peak_mib=peak,
            rollout_ms_per_step=[(r["train/rollout_s"]
                                  - r["train/capture_s"]) / T * 1e3
                                 for r in trains],
            capture_s=trains[0]["train/capture_s"],
            update_s=[r["train/update_s"] for r in trains],
            steps_per_sec=[r["train/steps_per_sec"] for r in trains],
            sum_reward_per_env=[r["train/sum_reward_per_env"]
                                for r in trains],
            params_moved=moved)
        if evals:
            rec["eval"] = {k.split("/")[1]: v for k, v in evals[-1].items()
                           if k.startswith("eval/")}
        log(f"[{label}] {task} {cfg['n_envs']} envs x {T} steps, "
            f"{chunks} chunk(s) in {wall:.3f} s: replayed rollout ms/step "
            f"{[round(v, 3) for v in rec['rollout_ms_per_step']]} (capture "
            f"{rec['capture_s']:.3f} s, not counted), s/update "
            f"{[round(v, 3) for v in rec['update_s']]}, env-steps/s "
            f"{[round(v, 1) for v in rec['steps_per_sec']]}, peak "
            f"{peak:.1f} MiB above the phase's start")
        if evals:
            log(f"[{label}] eval ({eval_steps} steps): {rec['eval']}")
        return rec

    def ppo_tasks(self):
        out = {}
        for task in PPO_TASKS:
            out[task] = self.ppo_train("ppo-tasks", task, 1,
                                       n_steps=PPO_TASK_STEPS,
                                       save_interval=1)
        sym = os.path.join(PPO_OUT, "ppo-tasks", "sym_0",
                           "walk_rl_sym_ep1.json")
        with open(sym) as f:
            n = len(json.load(f))
        if not n:
            raise RuntimeError("[ppo-tasks] sym exported an empty walk json")
        log(f"[ppo-tasks] sym exported {sym} ({n} steps)")
        out["sym"]["walk_json_steps"] = n
        return out

    def ppo_policy(self):
        """[ppo-policy]: the committed runs/walk_1 policy (best/970, as
        the .npz of rl/policies/) in a 500-step eval on the card."""
        torch, dev = self.torch, self.dev
        from opendog_tpu_torch.rl.evaluate import make_eval
        from opendog_tpu_torch.rl.networks import (COMMITTED_WALK_POLICY,
                                                   load_flax_params,
                                                   read_npz_tree)
        from opendog_tpu_torch.train import build
        _, env, net = build("walk", dev)
        load_flax_params(net, read_npz_tree(COMMITTED_WALK_POLICY))
        eval_fn = make_eval(env, net, PPO_EVAL_STEPS, dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        t0 = time.perf_counter()
        metrics, _ = eval_fn(None, env.draw_reset(gen, 1))
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        metrics, _ = eval_fn(None, env.draw_reset(gen, 1))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rec = {k: float(v) for k, v in metrics.items()}
        rec.update(ms_per_step=wall / PPO_EVAL_STEPS * 1e3,
                   first_call_s=first)
        log(f"[ppo-policy] runs/walk_1 best/970: episode_return "
            f"{rec['episode_return']:.3f}, episode_len "
            f"{rec['episode_len']:.0f}, forward_x {rec['forward_x']:.4f} m "
            f"in {PPO_EVAL_STEPS} steps; {rec['ms_per_step']:.3f} ms per "
            f"replayed eval step (the first call with its capture "
            f"{first:.3f} s); the artifact's record: 2.04 m on the JAX "
            "package's plant (not a target)")
        upright = rec["episode_len"] >= POLICY_MIN_STEPS
        if not (upright and rec["forward_x"] > POLICY_MIN_X):
            raise RuntimeError(f"[ppo-policy] {rec}: needs >= "
                               f"{POLICY_MIN_STEPS} upright steps and more "
                               f"than {POLICY_MIN_X} m")
        return rec

    # -- profile ----------------------------------------------------------
    def profile(self, label, tick, carry, n=PROFILE_TICKS):
        """Device busy share and kernel time by name over ``n`` ticks.  Only
        the profiler's own failures are caught; errors of the ticks
        propagate."""
        torch = self.torch
        from opendog_tpu_torch.physics import dynamics
        try:
            from torch.autograd import DeviceType
            from torch.profiler import ProfilerActivity, profile, record_function
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.start()
        except (ImportError, RuntimeError, AttributeError) as e:
            log(f"[profile] {label}: not measured ({type(e).__name__}: {e})")
            return
        planes_fn = dynamics.geom_local_planes

        def traced_planes(*a, **k):  # a range per call, read below
            with record_function("geom_local_planes"):
                return planes_fn(*a, **k)

        dynamics.geom_local_planes = traced_planes
        try:
            t0 = time.perf_counter()
            for _ in range(n):
                carry, _ = tick(carry)
            torch.cuda.synchronize()
            window_us = 1e6 * (time.perf_counter() - t0)
        finally:
            dynamics.geom_local_planes = planes_fn
        try:
            prof.stop()
            averages = prof.key_averages()
        except (RuntimeError, AttributeError) as e:
            log(f"[profile] {label}: not measured ({type(e).__name__}: {e})")
            return
        dev_us, kern_us, rows, planes = 0.0, 0.0, [], None
        for ev in averages:
            if ev.key == "geom_local_planes":
                # the host-side range; its device-side twin spans the
                # queue from its first to its last kernel, not kernel time
                if ev.device_type == DeviceType.CPU:
                    planes = ev
                continue
            if ev.device_type != DeviceType.CUDA:
                continue  # host-side events; their kernels are listed too
            t = getattr(ev, "self_device_time_total",
                        getattr(ev, "self_cuda_time_total", 0.0))
            dev_us += t
            if ev.key.startswith("substep_"):
                kern_us += t
            rows.append((t, ev.count, ev.key))
        for t, count, key in sorted(rows, reverse=True)[:8]:
            log(f"[profile] {label} {t / n:10.1f} us/tick  {count / n:7.1f} "
                f"calls/tick  {key[:70]}")
        if dev_us <= 0:
            log(f"[profile] {label}: device time not measured (the trace "
                "holds no device events)")
            return
        n_launch = sum(r[1] for r in rows)
        n_sub = sum(r[1] for r in rows if r[2].startswith("substep_"))
        log(f"[profile] {label} over {n} ticks: {window_us / n:.0f} us/tick, "
            f"device busy {100 * dev_us / window_us:.1f}%, substep kernels "
            f"{100 * kern_us / window_us:.1f}% ({n_sub / n:.0f} launches/"
            f"tick), other kernels {100 * (dev_us - kern_us) / window_us:.1f}"
            f"% ({(n_launch - n_sub) / n:.0f} launches/tick)")
        if planes is not None:
            log(f"[profile] {label} geom_local_planes: {planes.count / n:.0f} "
                f"calls/tick, host {planes.cpu_time_total / n:.0f} us/tick "
                f"({100 * planes.cpu_time_total / window_us:.1f}% of the "
                f"profiled tick)")

    def planes_cost(self, qpos, reps=50):
        """geom_local_planes alone, on the card: milliseconds per call by
        the host clock (ending in a synchronise) and by CUDA events, eager
        and replayed from a CUDA graph (its share of a replayed per-geom
        tick, which calls it twice), and its kernel launches per call from
        the profiler."""
        torch = self.torch
        from opendog_tpu_torch.physics import dynamics
        from opendog_tpu_torch.solvers import GraphedTick
        from opendog_tpu_torch.utils.profiling import event_ms
        planes = lambda q: dynamics.geom_local_planes(self.dog_t, self.terrain,
                                                      q)
        fn = lambda: planes(qpos)
        graphed = GraphedTick(planes, (qpos,), self.dev)
        graph_ms = event_ms(lambda: graphed(graphed.inputs[0]), reps)
        tick_ms = self.pairs["terrain"]["graph_ms"]
        log(f"[profile] geom_local_planes replayed from a CUDA graph: "
            f"{graph_ms:.4f} ms per call (CUDA events); 2 calls are "
            f"{100 * 2 * graph_ms / tick_ms:.1f}% of the replayed per-geom "
            f"tick's {tick_ms:.3f} ms")
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        host_ms = 1e3 * (time.perf_counter() - t0) / reps
        ev_ms = event_ms(fn, reps)
        launches = "not measured"
        try:
            from torch.autograd import DeviceType
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            launches = sum(ev.count for ev in prof.key_averages()
                           if ev.device_type == DeviceType.CUDA)
        except (ImportError, RuntimeError, AttributeError) as e:
            launches = f"not measured ({type(e).__name__}: {e})"
        log(f"[profile] geom_local_planes alone: {host_ms:.4f} ms per call "
            f"(host clock), {ev_ms:.4f} ms (CUDA events), {launches} kernel "
            f"launches per call; 2 calls per terrain tick")

    # -- multi-device (ROADMAP M14) ----------------------------------------
    def sharded_one(self):
        """[sharded-1]: the multi-device layer at world size 1 in this
        process, on an NCCL group on the card: bench_suite config 6's
        sharded solve, the sharded MPC tick with its all_reduce captured in
        a CUDA graph, the horizon-sharded iLQR pieces and a data-parallel
        PPO chunk, each equal to its unsharded counterpart bit for bit."""
        torch = self.torch
        import torch.distributed as dist
        from opendog_tpu_torch.parallel import initialize_distributed
        cuda = self.dev.type == "cuda"
        initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0,
                               device=None if cuda else "cpu")
        try:
            backend = dist.get_backend()
            log(f"[sharded-1] initialize_distributed at world size 1: "
                f"{backend}")
            if cuda and backend != "nccl":
                raise RuntimeError(f"[sharded-1] backend {backend}, not nccl")
            return dict(solve=self.sharded_solves(), mpc=self.sharded_mpc(),
                        ilqr=self.sharded_ilqr(), ppo=self.sharded_ppo())
        finally:
            dist.destroy_process_group()

    def sharded_solves(self):
        """Config 6's sample-sharded solve on a one-rank mesh against
        make_solver, on the same normals, receding for SHARDED_SOLVES
        solves from Go1's home state."""
        torch, dev, cs = self.torch, self.dev, self.cs
        from opendog_tpu_torch.parallel import sample_mesh
        from opendog_tpu_torch.physics import make_state
        from opendog_tpu_torch.solvers import mppi
        m, cost, cfg = config6(dev, ROLLOUT["K"])
        mesh = sample_mesh(1, device=dev)
        st, ms0 = make_state(m, "home"), mppi.init_state(m, cfg)
        gen = torch.Generator(device=dev).manual_seed(6)
        normals = [torch.randn((cfg.num_samples, cfg.horizon, m.nu),
                               generator=gen, device=dev)
                   for _ in range(SHARDED_SOLVES)]
        want = {cs.launch_key(ROLLOUT["K"], ROLLOUT["n"]):
                cfg.horizon * SHARDED_SOLVES}
        out, res = {}, {}
        for side, kw in (("plain", dict(device=dev)),
                         ("sharded", dict(mesh=mesh))):
            solve = mppi.make_solver(m, cost, cfg, **kw)
            solve(st, ms0, None, normals[0])  # warm-up
            torch.cuda.synchronize()

            def run():
                ms, outs = ms0, []
                t0 = time.perf_counter()
                for n in normals:
                    ctrl, ms, stats = solve(st, ms, None, n)
                    outs.append(dict(ctrl=ctrl, nominal=ms.nominal, **stats))
                torch.cuda.synchronize()
                return time.perf_counter() - t0, outs

            wall, res[side] = self.counted(f"sharded-1 {side} solve", run,
                                           want)
            out[f"{side}_ms_per_solve"] = 1e3 * wall / SHARDED_SOLVES
        self.same_bits("sharded-1", f"{SHARDED_SOLVES} sharded solves vs "
                       "make_solver's", stacked(torch, res["sharded"]),
                       stacked(torch, res["plain"]))
        from opendog_tpu_torch.parallel import collectives
        x = torch.zeros(1, cfg.horizon * m.nu + 3, device=dev)
        collectives.psum(x, mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            collectives.psum(x, mesh)
        torch.cuda.synchronize()
        out["psum_ms"] = 10.0 * (time.perf_counter() - t0)
        log(f"[sharded-1] config 6 (K={cfg.num_samples}, H={cfg.horizon}, "
            f"{cfg.n_substeps} x {cfg.rollout_dt} s on K1) eager ms/solve: "
            f"sharded {out['sharded_ms_per_solve']:.3f}, make_solver "
            f"{out['plain_ms_per_solve']:.3f} (same call, {SHARDED_SOLVES} "
            f"solves each); one eager psum of the update's (1, "
            f"{x.shape[1]}) buffer {out['psum_ms']:.4f} ms (host clock, 100 "
            "calls)")
        return out

    def sharded_mpc(self):
        """make_mpc(mesh=sample_mesh(1)): SHARDED_TICKS ticks eager, then as
        many replayed from the CUDA graph that holds the NCCL all_reduce,
        on the same normals: equal bit for bit, and to the unsharded
        make_mpc's ticks, 26 launches per replay; the unsharded ticks, eager
        and replayed, timed beside them in turns."""
        torch, dev, cs = self.torch, self.dev, self.cs
        from opendog_tpu_torch.parallel import sample_mesh
        from opendog_tpu_torch.physics import make_state
        from opendog_tpu_torch.solvers import graph_tick, make_mpc
        m, cost, cfg = config6(dev, ROLLOUT["K"])
        shape = (cfg.num_samples, cfg.horizon, m.nu)
        fns, first = {}, None
        for path, kw in (("sharded", dict(mesh=sample_mesh(1, device=dev))),
                         ("plain", dict(device=dev))):
            init, tick, _ = make_mpc(m, cost, cfg, plant_substeps=PLANT["n"],
                                     **kw)
            first = init(torch.Generator(device=dev).manual_seed(0),
                         make_state(m, "home"))
            t0 = time.perf_counter()
            gtick = graph_tick(tick, first, torch.zeros(shape, device=dev))
            torch.cuda.synchronize()
            per_replay = dict(gtick.graph.launches)
            log(f"[sharded-1] captured the {path} tick in "
                f"{time.perf_counter() - t0:.3f} s: "
                f"{graph_nodes(gtick.graph.graph)} graph nodes, launches per "
                f"replay {per_replay}")
            if sum(per_replay.values()) != cfg.horizon + 1:
                raise RuntimeError(f"[sharded-1] {per_replay} launches per "
                                   f"replay, not {cfg.horizon + 1}")
            fns[path] = dict(eager=tick, graph=gtick)
        gen = torch.Generator(device=dev).manual_seed(20)
        normals = [torch.randn(shape, generator=gen, device=dev)
                   for _ in range(SHARDED_TICKS)]
        want = {cs.launch_key(ROLLOUT["K"], ROLLOUT["n"]):
                cfg.horizon * SHARDED_TICKS,
                cs.launch_key(PLANT["K"], PLANT["n"]): SHARDED_TICKS}
        res, out = {}, {}
        for path, side in (("sharded", "eager"), ("plain", "eager"),
                           ("plain", "graph"), ("sharded", "graph")):
            fn = fns[path][side]

            def run():
                carry, outs = first, []
                t0 = time.perf_counter()
                for n in normals:
                    carry, o = fn(carry, n)
                    outs.append(dict(ctrl=o["ctrl"].clone(),
                                     qpos=o["qpos"].clone(),
                                     qvel=o["qvel"].clone(),
                                     nominal=carry.solver.nominal.clone()))
                torch.cuda.synchronize()
                return time.perf_counter() - t0, outs

            wall, res[path, side] = self.counted(
                f"sharded-1 mpc {path} {side}", run, want)
            out[f"{path}_{side}_ms_per_tick"] = 1e3 * wall / SHARDED_TICKS
        self.same_bits("sharded-1", f"graph vs eager, {SHARDED_TICKS} "
                       "sharded ticks", stacked(torch, res["sharded", "graph"]),
                       stacked(torch, res["sharded", "eager"]))
        self.same_bits("sharded-1", f"{SHARDED_TICKS} sharded ticks vs "
                       "make_mpc's", stacked(torch, res["sharded", "eager"]),
                       stacked(torch, res["plain", "eager"]))
        z = torch.stack([o["qpos"][2] for o in res["sharded", "eager"]])
        if not bool(((z > 0.12) & (z < 0.5)).all()):
            raise RuntimeError("[sharded-1] mpc: trunk z left (0.12, 0.5)")
        log("[sharded-1] make_mpc ms/tick, sharded (mesh=sample_mesh(1)) "
            f"and unsharded, in turns: eager {out['sharded_eager_ms_per_tick']:.3f}"
            f" / {out['plain_eager_ms_per_tick']:.3f}, graph "
            f"{out['sharded_graph_ms_per_tick']:.3f} / "
            f"{out['plain_graph_ms_per_tick']:.3f} (same call, "
            f"{SHARDED_TICKS} ticks each)")
        return out

    def sharded_ilqr(self):
        """The horizon-sharded Riccati sweep on a one-rank mesh: the
        associative gains of a random LQR problem at bench 3's shapes (H=50,
        Go1's nx=37, nu=12), and make_ilqr's solve of bench 3 at its
        horizon, cut to one iteration, on the CUDA default (graphs=True:
        the Riccati piece's graph holds sharded_suffix_scan's NCCL
        all_reduces), each against the unsharded one, bit for bit: the
        capturing solve and a replayed one."""
        torch, dev = self.torch, self.dev
        from opendog_tpu_torch.parallel import make_mesh
        from opendog_tpu_torch.solvers import ILQRConfig, costs, ilqr
        m = self.go1
        mesh = make_mesh(1, "sp", device=dev)
        H, nx, nu = 50, m.nq + m.nv, m.nu
        rng = np.random.default_rng(50)

        def t(*shape, scale=1.0):
            return torch.from_numpy((rng.normal(size=shape) * scale).astype(
                np.float32)).to(dev)

        eye_x = torch.eye(nx, device=dev)
        W, Wu = t(H, nx, nx, scale=0.3), t(H, nu, nu, scale=0.3)
        lqr = (t(H, nx, nx, scale=0.3) + eye_x, t(H, nx, nu, scale=0.3),
               t(H, nx), t(H, nu, scale=0.1), W @ W.mT + eye_x,
               Wu @ Wu.mT + torch.eye(nu, device=dev),
               t(H, nu, nx, scale=0.1), t(nx), 2.0 * eye_x)
        gains = [dict(zip(("k", "K", "dV"), ilqr.associative_lqr_gains(
            *lqr, 1e-9, **kw))) for kw in ({}, dict(mesh=mesh))]
        self.same_bits("sharded-1", f"sharded vs unsharded gains (H={H}, "
                       f"nx={nx}, nu={nu})", gains[1], gains[0])
        cost = costs.standing_cost(m, 0.265, m.key_qpos[0, 7:])
        icfg = ILQRConfig(n_substeps=2, rollout_dt=0.01,
                          riccati="associative", **SHARDED_ILQR)
        s0 = self.settled_go1()
        U0 = m.key_ctrl[0][None].repeat(icfg.horizon, 1)
        solves = {side: ilqr.make_ilqr(m, cost, icfg, device=dev,
                                       graphs=True, **kw)
                  for side, kw in (("plain", {}), ("sharded", dict(mesh=mesh)))}
        out = {}
        for call in ("capture", "replay"):
            res = {}
            for side, solve in solves.items():
                t0 = time.perf_counter()
                U, X, stats = self.counted(f"sharded-1 ilqr {side} {call}",
                                           lambda: solve(s0, U0), {})
                torch.cuda.synchronize()
                out[f"{side}_{call}_s"] = time.perf_counter() - t0
                res[side] = dict(U=U, X=X, **stats)
            self.same_bits("sharded-1", f"make_ilqr(mesh=) vs make_ilqr, "
                           f"graphs, the {call} solve", res["sharded"],
                           res["plain"])
            if not float(res["sharded"]["cost"]) < float(
                    res["sharded"]["initial_cost"]):
                raise RuntimeError("[sharded-1] ilqr: the solve did not "
                                   "improve")
        log(f"[sharded-1] make_ilqr (H={icfg.horizon}, {icfg.iterations} "
            f"iteration, graphs) s/solve, capture / replay: sharded "
            f"{out['sharded_capture_s']:.3f} / {out['sharded_replay_s']:.3f}"
            f", unsharded {out['plain_capture_s']:.3f} / "
            f"{out['plain_replay_s']:.3f}")
        return out

    def sharded_ppo(self):
        """make_sharded_ppo on a one-rank mesh against make_ppo: one walk
        chunk cut in depth (SHARDED_PPO_STEPS steps of 16 envs), its rollout
        step replayed from a CUDA graph, from the same generator seed:
        parameters, metrics, env states and observations equal bit for
        bit."""
        torch, dev = self.torch, self.dev
        from opendog_tpu_torch.envs.base import tree_leaves
        from opendog_tpu_torch.parallel import env_mesh, make_sharded_ppo
        from opendog_tpu_torch.rl.ppo import Hyper, PPOConfig, make_ppo
        from opendog_tpu_torch.train import TASKS, build
        cfg = PPOConfig(num_envs=16, n_steps=SHARDED_PPO_STEPS, num_epochs=2,
                        minibatch_size=16 * SHARDED_PPO_STEPS,
                        loss=TASKS["walk"]["loss"])
        res, out = [], {}
        for side in ("plain", "sharded"):
            _, env, net = build("walk", dev)
            init, chunk = (make_ppo(env, net, cfg, dev) if side == "plain"
                           else make_sharded_ppo(env, net, cfg,
                                                 env_mesh(1, device=dev)))
            state = init(torch.Generator(device=dev).manual_seed(0))
            t0 = time.perf_counter()
            state, metrics = self.counted(
                f"sharded-1 ppo {side}",
                lambda: chunk(state, Hyper(lr=1e-4, ent_coef=0.002)), {})
            out[f"{side}_chunk_s"] = time.perf_counter() - t0
            res.append(dict(**{k: v.detach() for k, v in state.params.items()},
                            **metrics, last_obs=state.last_obs,
                            **{f"env_state[{i}]": x for i, x in enumerate(
                                tree_leaves(state.env_states))}))
        self.same_bits("sharded-1", "make_sharded_ppo vs make_ppo", res[1],
                       res[0])
        log(f"[sharded-1] walk chunk (16 envs x {SHARDED_PPO_STEPS} steps, "
            f"graph rollout, capture included) s: sharded "
            f"{out['sharded_chunk_s']:.3f}, make_ppo {out['plain_chunk_s']:.3f}")
        return out

    def sharded_two(self):
        """[sharded-2]: two ranks on the one card over gloo, started with
        the spawn method (CUDA is live here); each loads the kernel library
        built above.  Each rank runs SHARDED_SOLVES config-6 solves at
        K_local=256 and the blocked suffix scan; the ranks' outputs must be
        the same bits, rank 0's match a one-process K=512 solve on the same
        normals from the same nominal within SHARDED_TOL (each solve) and
        the scan the unsharded one within SCAN_TOL."""
        import tempfile
        import torch.multiprocessing as torch_mp
        torch, dev, cs = self.torch, self.dev, self.cs
        from opendog_tpu_torch.physics import make_state
        from opendog_tpu_torch.solvers import ilqr, mppi
        n, K = SHARDED_RANKS, ROLLOUT["K"]
        m, cost, cfg = config6(dev, K * n)
        gen = torch.Generator().manual_seed(26)
        normals = torch.randn((SHARDED_SOLVES, K * n, cfg.horizon, m.nu),
                              generator=gen)
        elems = random_vf_elems(np.random.default_rng(51), 51, m.nq + m.nv)
        device = None if dev.type == "cuda" else "cpu"
        with tempfile.TemporaryDirectory() as tmp:
            torch.save(dict(normals=normals, elems=elems),
                       os.path.join(tmp, "inputs.pt"))
            t0 = time.perf_counter()
            ctx = torch_mp.start_processes(
                sharded_rank, args=(n, f"127.0.0.1:{free_port()}", tmp,
                                    device),
                nprocs=n, join=False, start_method="spawn")
            try:
                while not ctx.join(timeout=5):
                    if time.perf_counter() - t0 > SHARDED_TIMEOUT_S:
                        raise RuntimeError("[sharded-2] the ranks did not end "
                                           f"in {SHARDED_TIMEOUT_S} s")
            finally:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                        p.join()
            ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                     for r in range(n)]
        wall = time.perf_counter() - t0
        want = {cs.launch_key(K, ROLLOUT["n"]): cfg.horizon * SHARDED_SOLVES}
        for r, res in enumerate(ranks):
            log(f"[sharded-2] rank {r} kernel launches: {res['launches']}")
            if res["launches"] != want:
                raise RuntimeError(f"[sharded-2] rank {r}: launches "
                                   f"{res['launches']} != {want}")
            self.attribute(res["launches"])
        for r in range(1, n):
            self.same_bits("sharded-2", f"rank {r} vs rank 0",
                           stacked(torch, ranks[r]["outs"]),
                           stacked(torch, ranks[0]["outs"]))
        # the one-process solve of all K * n samples on the same normals,
        # each from the nominal that rank 0's solve started from
        solve = mppi.make_solver(m, cost, cfg, device=dev)
        st = make_state(m, "home")
        starts = [mppi.MPPIState(nominal=o["start"].to(dev))
                  for o in ranks[0]["outs"]]
        solve(st, starts[0], None, normals[0].to(dev))  # warm-up
        torch.cuda.synchronize()

        def run():
            outs = []
            for ms, x in zip(starts, normals):
                ctrl, ms, stats = solve(st, ms, None, x.to(dev))
                outs.append(dict(ctrl=ctrl.cpu(), nominal=ms.nominal.cpu()))
            return outs

        ref = self.counted("sharded-2 one-process reference", run,
                           {cs.launch_key(K * n, ROLLOUT["n"]):
                            cfg.horizon * SHARDED_SOLVES},
                           rows=["flat sharded reference"])
        err = max(float((a[k] - b[k]).abs().max())
                  for a, b in zip(ranks[0]["outs"], ref)
                  for k in ("ctrl", "nominal"))
        full = ilqr._suffix_scan(tuple(e.to(dev) for e in elems))
        scan_err = max(float((a.to(dev) - b).abs().max())
                       for a, b in zip(ranks[0]["scan"], full))
        per_solve = [float(np.median(res["ms"])) for res in ranks]
        log(f"[sharded-2] {n} ranks over gloo on one card ({nvidia_smi_line()}"
            f"), {wall:.1f} s with the spawn: config 6 at K_local={K} "
            f"(K={K * n}), median ms/solve per rank {per_solve}; rank 0 vs "
            f"the one-process K={K * n} solve from the same nominal: max abs "
            f"{err:.3e} "
            f"(tolerance {SHARDED_TOL:.0e}); sharded_suffix_scan (L=51, "
            f"nx={m.nq + m.nv}) vs the unsharded scan: max abs "
            f"{scan_err:.3e} (tolerance {SCAN_TOL:.0e})")
        if not err <= SHARDED_TOL:
            raise RuntimeError(f"[sharded-2] rank 0 vs one process: {err}")
        if not scan_err <= SCAN_TOL:
            raise RuntimeError(f"[sharded-2] scan vs unsharded: {scan_err}")
        return dict(ms_per_solve=per_solve, max_abs_vs_one_process=err,
                    scan_max_abs=scan_err, wall_s=wall)

    # -- the multi-device scripts ------------------------------------------
    def multidev(self):
        """[multidev]: scripts/torch_multiprocess_scaling.py,
        torch_scaling_bench.py and torch_comm_volume.py, each a subprocess
        (its own process group, killed whole on the time limit) that starts its
        ranks at world size 1 over NCCL on the card, the three at once.
        Each record must carry the JAX record's keys, finite results and the
        backend nccl; the comm-volume counts must equal COMM_COUNTS_1; the
        ranks' kernel launches over their timed windows go to the K1 rows
        of their shapes."""
        import signal
        import tempfile
        cs = self.cs
        jobs = dict(
            multiprocess_scaling=["--nprocs", "1", "--ticks",
                                  str(MULTIDEV_TICKS)],
            scaling_bench=["--device-counts", "1", "--steps",
                           str(MULTIDEV_STEPS)],
            comm_volume=["--ranks", "1", "--reps", str(MULTIDEV_REPS)])
        if self.dev.type != "cuda":
            for args in jobs.values():
                args += ["--device", "cpu"]
        with tempfile.TemporaryDirectory() as tmp:
            procs, logs = {}, {}
            t0 = time.perf_counter()
            for name, args in jobs.items():
                logs[name] = open(os.path.join(tmp, name + ".log"), "w+")
                procs[name] = subprocess.Popen(
                    [sys.executable, os.path.join(ROOT, "scripts",
                                                  f"torch_{name}.py"),
                     *args, "--out", os.path.join(tmp, name)],
                    cwd=ROOT, stdout=logs[name], stderr=subprocess.STDOUT,
                    start_new_session=True)
            try:
                while any(p.poll() is None for p in procs.values()):
                    if time.perf_counter() - t0 > MULTIDEV_TIMEOUT_S:
                        raise RuntimeError("[multidev] the scripts did not "
                                           f"end in {MULTIDEV_TIMEOUT_S} s")
                    time.sleep(0.2)
            finally:
                for p in procs.values():
                    if p.poll() is None:
                        os.killpg(p.pid, signal.SIGKILL)
                    p.wait()
            wall = time.perf_counter() - t0
            for name, p in procs.items():
                logs[name].seek(0)
                text = logs[name].read()
                logs[name].close()
                if p.returncode != 0:
                    raise RuntimeError(f"[multidev] torch_{name}.py exited "
                                       f"{p.returncode}:\n{text[-6000:]}")
            recs = {}
            for name in jobs:
                with open(os.path.join(tmp, name, "metrics.json")) as f:
                    recs[name] = json.load(f)
        backend = "nccl" if self.dev.type == "cuda" else "gloo"
        for name, rec in recs.items():
            if rec["backend"] != backend:
                raise RuntimeError(f"[multidev] {name}: backend "
                                   f"{rec['backend']}, not {backend}")
        mps, sb, cv = (recs[k] for k in jobs)
        for key in ("mppi_weak_scaling", "env_rollout_weak_scaling"):
            for e in mps[key]:
                missing = {"mode", "nproc", "finite",
                           "weak_scaling_efficiency"} - set(e)
                if missing or not e["finite"]:
                    raise RuntimeError(f"[multidev] multiprocess {key}: "
                                       f"missing {missing} or not finite")
        mppi, envs = mps["mppi_weak_scaling"][0], mps[
            "env_rollout_weak_scaling"][0]
        K, n = MULTIDEV_ROLLOUT["K"], MULTIDEV_ROLLOUT["n"]
        # solves x the script's horizon (10)
        want = {cs.launch_key(K, n): MULTIDEV_TICKS * 10}
        if self.dev.type != "cuda":
            want = {}   # the plain version counts no launch
        for label, got, expect in (("mppi", mppi["launches"], want),
                                   ("envs", envs["launches"], {})):
            log(f"[multidev] multiprocess {label} kernel launches (rank 0, "
                f"timed window): {got}")
            if got != expect:
                raise RuntimeError(f"[multidev] multiprocess {label} "
                                   f"launches {got} != {expect}")
        self.attribute(mppi["launches"], rows=["flat multidev rollout"])
        if not (sb["1"]["env_steps_per_sec"] > 0 and sb["finite"]):
            raise RuntimeError(f"[multidev] scaling_bench: {sb}")
        for section, counts in COMM_COUNTS_1.items():
            rec = cv[section]
            got = rec["by_collective"]
            if got != counts:
                raise RuntimeError(f"[multidev] comm_volume {section}: "
                                   f"counts {got} != {counts}")
            unit = "chunk_ms" if "ppo" in section else "solve_ms"
            times = [rec["collective_us"], rec[unit], rec["efficiency_1dev"]]
            if not all(np.isfinite(t) and t > 0 for t in times):
                raise RuntimeError(f"[multidev] comm_volume {section}: "
                                   f"times {times}")
        cv_launches = cv["mppi_sample_sharded_k4096"]["launches"]
        # timed solves x the solve's horizon (25)
        want = ({cs.launch_key(4096, 2): 25 * MULTIDEV_REPS}
                if self.dev.type == "cuda" else {})
        if cv_launches != want:
            raise RuntimeError(f"[multidev] comm_volume mppi launches "
                               f"{cv_launches} != {want}")
        self.attribute(cv_launches, rows=["flat distill expert"])
        out = dict(
            wall_s=wall,
            mppi_solves_per_sec=mppi["solves_per_sec"],
            mppi_best_cost=mppi["best_cost"],
            env_ticks_per_sec=envs["env_ticks_per_sec"],
            scaling_bench_env_steps_per_sec=sb["1"]["env_steps_per_sec"],
            **{f"{k}_{u}": cv[k][u] for k in COMM_COUNTS_1
               for u in ("collective_us", "solve_ms", "chunk_ms")
               if u in cv[k]})
        log(f"[multidev] the three scripts at world size 1 over {backend} "
            f"({nvidia_smi_line()}), concurrently, {wall:.1f} s: "
            + json.dumps(out))
        return out

    # -- timing -----------------------------------------------------------
    def timing(self):
        from opendog_tpu_torch.utils.profiling import (
            CHIP_PEAKS, cost_row, event_ms, substep_bound, substep_row,
            tracking_cost_bound)
        peak_flops = CHIP_PEAKS["h100"]["fp32_flops"]
        peak_bytes = CHIP_PEAKS["h100"]["hbm_bytes"]
        kernels = []
        for label, rec in self.records.items():
            shape, model = rec["shape"], rec["model"]
            K, n = shape["K"], shape["n"]
            args = rec["args"]
            ms = event_ms(lambda: rec["kern"](*args),
                          200 if n * K < 20000 else 50)
            # the check phase's call of the plain version was its warm-up
            plain_ms = event_ms(lambda: rec["plain"](*args), 1,
                                warm_up=False)
            bound = substep_bound(model, shape["dt"], n, rec["modes"], args)
            bound_ms, bound_by, ops, nbytes = bound
            design = self.cs.KERNEL_DESIGNS[rec["name"]]
            entry = rec["kern"].entry  # the size class's, where it has one
            log(f"[timing] {label} ({entry}, {design} design) K={K} "
                f"x{n}: kernel "
                f"{ms:.4f} ms, plain {plain_ms:.2f} ms, bound {bound_ms:.6f} "
                f"ms by {bound_by} ({ops} ops at {peak_flops / 1e12:g} "
                f"TFLOP/s fp32 vs {nbytes} B at {peak_bytes / 1e12:g} TB/s; "
                f"{100 * bound_ms / ms:.3f}% of bound); "
                f"launches on the paths {rec['launches']}; library call: "
                f"none computes this function")
            kernels.append(dict(substep_row(
                f"{entry} ({label}: K={K}, {n} substeps)",
                rec["launches"], rec["err"], ms, plain_ms, bound),
                design=design))
        graphed = script_module("torch_exact_plant").graphed
        for label, rec in self.cost_records.items():
            K, model = rec["K"], rec["model"]
            ms = event_ms(rec["kernel"], 200)
            op_ms = event_ms(rec["op"], 200)
            # replayed as the tick replays them: COST_STEPS launches a graph
            replayed_ms = graphed(self.torch, lambda: [
                rec["kernel"]() for _ in range(COST_STEPS)], 200) / COST_STEPS
            op_replayed_ms = graphed(self.torch, rec["op"], 200)
            bound = tracking_cost_bound(model, K)
            bound_ms, bound_by, ops, nbytes = bound
            log(f"[timing] cost {label} ({self.cs.ROLLOUT_COST}) L={K}: "
                f"kernel {1e3 * ms:.2f} us eager, {1e3 * replayed_ms:.2f} us "
                f"replayed; op path {1e3 * op_ms:.1f} us eager, "
                f"{1e3 * op_replayed_ms:.1f} us replayed; bound "
                f"{1e3 * bound_ms:.4f} us by {bound_by} ({ops} ops vs "
                f"{nbytes} B; {100 * bound_ms / replayed_ms:.3f}% of bound "
                f"replayed); launches on the paths {rec['launches']}")
            kernels.append(dict(cost_row(
                f"{self.cs.ROLLOUT_COST} ({label}: L={K})", rec["launches"],
                rec["err"], ms, op_ms, bound), replayed_ms=replayed_ms,
                plain_replayed_ms=op_replayed_ms))
        for label, rec in (*self.records.items(),
                           *self.cost_records.items()):
            if rec["launches"] < 1:
                raise RuntimeError(f"[timing] {label}: no path launched "
                                   f"{rec['key']}")
        return kernels


def script_module(name):
    """scripts/<name>.py as a module (its main not run)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ppo_rollout_pair(torch, dev, task, n_envs, n_steps, seed=0):
    """One chunk of ``task`` (its TASKS network and loss; 1 epoch of one
    minibatch) from the same initial state and the same draws, eager and
    with the rollout step replayed from its CUDA graph.  Returns {graphs:
    dict(traj, env_states, last_obs, rollout_s)}."""
    from opendog_tpu_torch.rl.ppo import (Hyper, PPOConfig, draw_chunk,
                                          make_ppo)
    from opendog_tpu_torch.train import TASKS, build
    out = {}
    for graphs in (False, True):
        _, env, net = build(task, dev)
        cfg = PPOConfig(num_envs=n_envs, n_steps=n_steps, num_epochs=1,
                        minibatch_size=n_envs * n_steps,
                        loss=TASKS[task]["loss"])
        init, chunk = make_ppo(env, net, cfg, dev, graphs=graphs)
        gen = torch.Generator(device=dev).manual_seed(seed)
        state = init(gen)
        draws = draw_chunk(env, cfg, gen, dev)
        state, _ = chunk(state, Hyper(lr=1e-4, ent_coef=0.002), draws)
        out[graphs] = dict(
            traj={k: v.clone() for k, v in chunk.rollout.traj.items()},
            env_states=state.env_states, last_obs=state.last_obs,
            rollout_s=chunk.times["rollout_s"])
    return out


def ppo_pair_differences(torch, pair):
    """Fields of the eager and graph rollouts of ``ppo_rollout_pair`` that
    are not equal bit for bit (every trajectory buffer, every env state
    field, the last observations), and the number compared."""
    from opendog_tpu_torch.envs.base import tree_leaves
    eager, graph = pair[False], pair[True]
    items = [(f"traj.{k}", v, graph["traj"][k])
             for k, v in eager["traj"].items()]
    items += [(f"env_state[{i}]", a, b) for i, (a, b) in enumerate(zip(
        tree_leaves(eager["env_states"]), tree_leaves(graph["env_states"])))]
    items.append(("last_obs", eager["last_obs"], graph["last_obs"]))
    bad = [k for k, a, b in items if not torch.equal(a, b)]
    return bad, len(items)


def read_metrics(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def stacked(torch, outs):
    """A list of dicts of tensors (one per call) as one dict of stacks."""
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def config6(dev, K, horizon=25):
    """scripts/bench_suite.py config 6 (258-271) on ``dev`` with K samples:
    (Go1 flat, its trot cost at 0.5 m/s and 0.265 m, MPPIConfig)."""
    from opendog_tpu_torch.assets import load_go1
    from opendog_tpu_torch.solvers import MPPIConfig, costs
    m = load_go1("flat", device=dev)
    params = costs.TrotCostParams(desired_vel_xy=(0.5, 0.0),
                                  target_height=0.265)
    cost = costs.trot_cost(m, params, m.key_qpos[0, 7:], legs="go1")
    return m, cost, MPPIConfig(horizon=horizon, num_samples=K, n_substeps=2,
                               rollout_dt=0.01, noise_sigma=0.12,
                               temperature=0.3)


def random_vf_elems(rng, L, nx):
    """Random value-function blocks (F, c, C, eta, J), C and J symmetric
    positive semi-definite, as tests/test_sharded_solvers.py draws them."""
    import torch

    def n(*shape, scale):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(
            np.float32))

    F = n(L, nx, nx, scale=0.3) + torch.eye(nx)
    Wc, Wj = n(L, nx, nx, scale=0.2), n(L, nx, nx, scale=0.2)
    return (F, n(L, nx, scale=0.3), Wc @ Wc.mT, n(L, nx, scale=0.3),
            Wj @ Wj.mT)


def sharded_rank(rank, n, addr, tmp, device):
    """One rank of [sharded-2], started by spawn: gloo over ``addr``, the
    card shared with the other ranks (or ``device="cpu"``).  Runs a
    config-6 solve on each of the global normals of ``tmp/inputs.pt``
    (solves, K, H, nu) with the launches counted, then the blocked suffix
    scan of its blocks, writes ``tmp/rank{rank}.pt`` and leaves with
    ``os._exit(0)``."""
    import torch
    import torch.distributed as dist
    from opendog_tpu_torch.ops import cuda_step
    from opendog_tpu_torch.parallel import (initialize_distributed,
                                            make_mesh, sample_mesh)
    from opendog_tpu_torch.physics import make_state
    from opendog_tpu_torch.solvers import ilqr, mppi
    torch.backends.cuda.matmul.allow_tf32 = False
    inp = torch.load(os.path.join(tmp, "inputs.pt"))
    initialize_distributed(addr, n, rank, backend="gloo", device=device)
    mesh = sample_mesh(n, device=device)
    dev = mesh.device
    normals = inp["normals"].to(dev)
    m, cost, cfg = config6(dev, normals.shape[1], normals.shape[2])
    solve = mppi.make_solver(m, cost, cfg, mesh=mesh)
    st, ms = make_state(m, "home"), mppi.init_state(m, cfg)
    solve(st, ms, None, normals[0])  # warm-up: loads the kernels
    torch.cuda.synchronize()
    cuda_step.LAUNCHES.clear()
    outs, times = [], []
    for x in normals:
        start = ms.nominal.cpu()
        t0 = time.perf_counter()
        ctrl, ms, stats = solve(st, ms, None, x)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        outs.append({k: v.cpu() for k, v in dict(
            ctrl=ctrl, nominal=ms.nominal, start=start,
            **stats).items()})
    launches = dict(cuda_step.LAUNCHES)
    scan = ilqr.sharded_suffix_scan(
        tuple(e.to(dev) for e in inp["elems"]),
        make_mesh(n, "sp", device=device))
    torch.save(dict(outs=outs, ms=times, launches=launches,
                    scan=[x.cpu() for x in scan]),
               os.path.join(tmp, f"rank{rank}.pt"))
    # Leave without tearing the group down: a rank that destroys its group
    # or exits normally while a peer still tears down (rank 0 hosts the TCP
    # store) can abort in c10d's threads ("terminate called without an
    # active exception").  After the barrier every rank is past its last
    # collective; rank 0, the store's host, leaves last.
    dist.barrier()
    open(os.path.join(tmp, f"done{rank}"), "w").close()
    t0 = time.monotonic()
    while rank == 0 and time.monotonic() - t0 < 60 and not all(
            os.path.exists(os.path.join(tmp, f"done{r}")) for r in range(n)):
        time.sleep(0.01)
    sys.stdout.flush()
    os._exit(0)


def occupancy(lib, cs, smoke):
    """Prints the launch shape of each entry point's kernel for the model
    of its paths (Go1 for the flat modes, OpenDOG for the plane modes), and
    of the plane + payload kernel for a model above the small size class;
    raises where the card could not hold one block of a kernel."""
    n_max = cs.table_layout()[0]["SC_NG_MAX"]
    rows = [(name, with_plane, with_payload,
             (smoke.go1 if with_plane is False else smoke.dog).ngeom)
            for (with_plane, with_payload), name in cs.KERNEL_NAMES.items()]
    rows.append((cs.KERNEL_NAMES[(True, True)], True, True, n_max))
    for name, with_plane, with_payload, ngeom in rows:
        args = (cs._PLANE_CODE[with_plane], int(with_payload), ngeom)
        warps = lib.substep_warps_per_block(*args)
        smem = lib.substep_warp_smem_bytes(*args)
        blocks = lib.substep_warp_occupancy(*args)
        log(f"[build] {name} at {ngeom} spheres: {warps} rollouts (warps) "
            f"per block, {smem} B of dynamic shared memory per block, "
            f"{blocks} blocks = {blocks * warps} warps per SM")
        if not blocks >= 1:
            raise RuntimeError(f"[build] {name} at {ngeom} spheres: "
                               f"occupancy {blocks}")


def ppo_phases(smoke):
    """The PPO training phases (train.py's path), in order."""
    return dict(graph=smoke.ppo_graph(),
                walk=smoke.ppo_train("ppo-walk", "walk", PPO_WALK_CHUNKS,
                                     eval_steps=PPO_WALK_EVAL_STEPS),
                walk_1024=smoke.ppo_train("ppo-walk-1024", "walk", 1,
                                          n_envs=PPO_WIDE_ENVS,
                                          num_epochs=PPO_WIDE_EPOCHS),
                tasks=smoke.ppo_tasks(),
                policy=smoke.ppo_policy())


def bridge_phases(smoke):
    """The robot bridge phases (apps/mpc_bridge.py, sim2real/), in order."""
    return {"mpc-bridge": smoke.mpc_bridge(),
            "student-bridge": smoke.student_bridge(),
            "gait-replay": smoke.gait_replay()}


def sharded_phases(smoke):
    """The multi-device phases (parallel/, ROADMAP M14), in order."""
    return {"sharded-1": smoke.sharded_one(),
            "sharded-2": smoke.sharded_two()}


def multidev_phases(smoke):
    """The multi-device scripts' phase (scripts/torch_*.py on parallel/)."""
    return smoke.multidev()


def perception_phases(smoke):
    """The perception phase (apps/slam.py .. mono_depth.py, ROADMAP M15b)."""
    return smoke.perception()


def apps_phases(smoke):
    """The apps phase (telemetry/, voice, cloning, nnvis: ROADMAP M15c)."""
    return smoke.apps()


def scripts_phases(smoke):
    """The application scripts' phase (scripts/torch_*.py)."""
    return smoke.scripts()


def bench_suite_phases(smoke):
    """The benchmark suite's phase (scripts/torch_bench_suite.py)."""
    return smoke.bench_suite()


def main(argv=None):
    """``--only ppo`` (``bridge``, ``sharded``, ``multidev``,
    ``perception``, ``apps``, ``scripts``, ``bench-suite``) runs the device
    phase and the PPO phases (the bridge phases, the multi-device phases,
    the multi-device scripts' phase, the perception phase, the apps phase,
    the scripts' phase, the benchmark suite's phase) alone: a development
    aid, with no kernel checked and no "ok" line."""
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--only", choices=["ppo", "bridge", "sharded",
                                      "multidev", "perception", "apps",
                                      "scripts", "bench-suite"],
                   default=None)
    args = p.parse_args(argv)
    start = time.perf_counter()
    import torch

    # ---- device ----
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from opendog_tpu_torch.ops import cuda_step

    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {kind} x{torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    if args.only is not None:
        smoke = Smoke(torch, dev)
        res = dict(ppo=ppo_phases, bridge=bridge_phases,
                   sharded=sharded_phases, multidev=multidev_phases,
                   perception=perception_phases,
                   apps=apps_phases,
                   scripts=scripts_phases,
                   **{"bench-suite": bench_suite_phases})[args.only](smoke)
        log(f"[summary] {args.only}: " + json.dumps(res))
        log(f"[summary] wall time {time.perf_counter() - start:.1f} s")
        log(smi)
        return 0

    # ---- build ----
    lib, built = cuda_step.cuda_library()
    log(f"[build] {built.path} built in {built.seconds:.1f} s")
    for line in built.log.splitlines():
        if any(w in line for w in ("registers", "spill", "stack", "Compiling")):
            log(f"[build] {line.strip()}")
    for name in (*cuda_step.KERNEL_NAMES.values(), cuda_step.EXACT_PLANT,
                 cuda_step.ROLLOUT_COST):
        if f"'{name}'" not in built.log:
            raise RuntimeError(f"[build] no ptxas report of {name}")
    smoke = Smoke(torch, dev)
    occupancy(lib, cuda_step, smoke)

    def mark(phases):
        log(f"[wall] {phases} done at {time.perf_counter() - start:.1f} s")

    smoke.check_all()
    smoke.ops_check()
    mark("build, check, ops-check")
    flat = smoke.flat_loop()
    terr = smoke.terrain_loop("terrain", "per_geom", TERRAIN_TICKS)
    smoke.terrain_loop("terrain-trunk", "trunk", TRUNK_TICKS)
    exact = smoke.terrain_loop("exact-terrain", "trunk", EXACT_TICKS,
                               terrain_plant="exact")
    deviation = smoke.deviation(terr, exact)
    mark("main, terrain loops")
    smoke.ops_engine()
    smoke.payload_solves()
    smoke.batch_steps()
    smoke.pergeom_payload_solves()
    mark("ops-engine, payload, batch")
    ilqr = smoke.ilqr()
    mark("ilqr")
    ilqr_trot = smoke.ilqr_trot()
    mark("ilqr-trot")
    realtime = smoke.realtime(flat)
    bridge = smoke.bridge(flat, realtime["host_loop_control_delay_ticks"])
    mark("realtime, bridge")
    distill = smoke.distill("distill", 0.0, DISTILL["rounds"],
                            DISTILL["ticks"], DISTILL["eval_ticks"])
    distill_payload = smoke.distill("distill-payload",
                                    PAYLOAD_DISTILL["payload_hi"], 1,
                                    PAYLOAD_DISTILL["ticks"], 0)
    bench5 = smoke.bench5()
    students = smoke.students()
    mark("distill phases, student")
    sharded = sharded_phases(smoke)
    mark("sharded-1, sharded-2")
    multidev = smoke.multidev()
    mark("multidev")
    bridge_out = bridge_phases(smoke)
    mark("robot bridge phases")
    ppo = ppo_phases(smoke)
    mark("ppo phases")
    perception = perception_phases(smoke)
    mark("perception")
    apps = apps_phases(smoke)
    mark("apps")
    scripts = scripts_phases(smoke)
    mark("scripts")
    bench = bench_suite_phases(smoke)
    mark("bench-suite")
    for label, path in (("flat", flat), ("terrain", terr),
                        ("exact-terrain", exact)):
        smoke.profile(f"{label} eager", path["tick"], path["carry"])
        smoke.profile(f"{label} graph", path["gtick"], path["carry"])
    smoke.planes_cost(terr["carry"].plant.qpos)
    mark("profile")
    kernels = smoke.timing()
    mark("timing")

    # ---- summary ----
    log("[summary] eager and graph ms per path (same call): "
        + json.dumps(smoke.pairs))
    log("[summary] realtime: " + json.dumps(realtime))
    log("[summary] bridge: " + json.dumps(bridge))
    log("[summary] ilqr (bench 3): " + json.dumps(ilqr))
    log("[summary] ilqr-trot (bench 3b): " + json.dumps(ilqr_trot))
    log("[summary] terrain final_dev_vs_exact_plant_m: "
        + json.dumps(deviation))
    for label, fields in (("distill", distill),
                          ("distill-payload", distill_payload)):
        log(f"[summary] {label}: " + json.dumps(
            {k: v for k, v in fields.items() if k != "rounds"}))
    log("[summary] distill-bench5 (5_distill_round): " + json.dumps(bench5))
    log("[summary] student: " + json.dumps(
        {run: {k: v for k, v in rec.items() if k != "per_command"}
         for run, rec in students.items()}))
    log("[summary] robot bridge: " + json.dumps(bridge_out))
    log("[summary] multi-device: " + json.dumps(sharded))
    log("[summary] multi-device scripts: " + json.dumps(multidev))
    log("[summary] ppo: " + json.dumps(ppo))
    log("[summary] perception: " + json.dumps(perception))
    log("[summary] apps: " + json.dumps(apps))
    log("[summary] scripts: " + json.dumps(scripts))
    log("[summary] bench-suite: " + json.dumps(bench))
    log(f"[summary] wall time {time.perf_counter() - start:.1f} s")
    log(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
