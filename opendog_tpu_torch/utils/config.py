"""Typed configuration tree (a copy of the JAX package's
``utils/config.py``, which imports no JAX).

The reference scatters its knobs across module-level UPPER_CASE constant
blocks and inline dicts (SURVEY §5: ``sim2real/train.py:25-104``,
``run_robot.py:27-73``, ``run.py:25-36``, ``udp_walk.py:30-57``).  Here every
operational constant is a first-class field of one dataclass tree with the
reference values as defaults and provenance in comments.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple


@dataclass(frozen=True)
class RobotNetworkConfig:
    """Robot endpoints + firmware control parameters."""

    ip1: str = "192.168.137.100"        # quadpilot/body.py:8
    ip2: str = "192.168.137.101"
    udp_port: int = 12345               # esp32_motors.ino:14
    camera_ip: str = "192.168.137.102"
    camera_port: int = 81               # esp32cam.ino:277
    # firmware PID defaults (esp32_motors.ino:25-30)
    pid_p: float = 0.9
    pid_i: float = 0.001
    pid_d: float = 0.3
    dead_zone: int = 10
    pos_thresh: int = 5
    counts_per_rev: int = 1975          # esp32_motors.ino:32
    telemetry_interval_ms: int = 50     # esp32_motors.ino:369
    # motor bring-up pin map (run_robot.py / udp_walk.py pin tables)
    pins: Tuple[Tuple[int, int, int, int], ...] = (
        (39, 40, 41, 42), (16, 15, 6, 7), (17, 18, 8, 9), (10, 11, 1, 2),
        (39, 40, 41, 42), (16, 15, 6, 7), (17, 18, 8, 9), (10, 11, 1, 2),
    )


@dataclass(frozen=True)
class SimConfig:
    timestep: float = 0.002             # MuJoCo default, both models
    frame_skip: int = 10                # WalkEnvironment.py:36 (50 Hz)
    settle_steps: int = 100             # sim2real/train.py:91


@dataclass(frozen=True)
class SymWalkTaskConfig:
    """Flat-ground symmetric-gait task (sim2real/train.py:50-93)."""

    max_steps_per_episode: int = 250
    policy_decision_dt: float = 0.10
    action_amplitude_deg: float = 40.0
    orientation_termination_deg: float = 25.0
    orientation_penalty_deg: float = 5.0
    yaw_penalty_deg: float = 10.0
    leg_at_home_threshold_deg: float = 15.0
    moving_leg_max_deviation_deg: float = 40.0
    leg_positioning_penalty: float = 0.5
    phase_cycle_steps: int = 2
    json_steps_episodic: int = 50
    json_steps_final: int = 100
    pth_save_interval: int = 100


@dataclass(frozen=True)
class TerrainTaskConfig:
    """Heightfield task (sim2real/train2.py:84-115)."""

    max_steps_per_episode: int = 1000
    policy_decision_dt: float = 0.08
    action_amplitude_deg: float = 50.0
    orientation_termination_deg: float = 35.0
    terrain_rows: int = 100
    terrain_cols: int = 100
    terrain_max_abs_height: float = 1.5
    terrain_smoothness: float = 0.3
    terrain_smooth_passes: int = 4
    flat_probability: float = 0.5
    z_stability_coef: float = 0.25


@dataclass(frozen=True)
class SB3TrainConfig:
    """SB3 PPO configuration (train/train.py:117-130,154)."""

    total_timesteps: int = 30_000_000
    n_envs: int = 4
    learning_rate: float = 1e-4
    n_steps: int = 2048
    batch_size: int = 512
    n_epochs: int = 10
    gamma: float = 0.99
    ent_coef: float = 0.005
    clip_range: float = 0.2
    max_grad_norm: float = 0.5


@dataclass(frozen=True)
class CustomTrainConfig:
    """Custom PPO stack (sim2real/train.py:55-70)."""

    num_episodes: int = 10_000
    policy_update_interval: int = 2048
    num_epochs_per_update: int = 10
    gamma: float = 0.99
    gae_lambda: float = 0.95
    value_loss_coef: float = 0.5
    max_grad_norm: float = 0.5
    initial_learning_rate: float = 1e-4
    initial_entropy_coef: float = 0.002
    initial_action_std: float = 0.4
    adaptation_check_interval: int = 10
    hidden_sizes: Tuple[int, int] = (512, 256)     # train.py:135-144
    terrain_hidden_sizes: Tuple[int, int] = (1024, 512)  # train2.py:152-153


@dataclass(frozen=True)
class RuntimeConfig:
    """Real-time loop rates (SURVEY §6)."""

    control_loop_hz: float = 12.5       # run_robot.py:37
    mpc_tick_hz: float = 50.0           # the MPC tick's target (BASELINE.json)
    telemetry_stream_hz: float = 30.0   # wireless_comunication/server.py:20
    firmware_pid_hz: float = 500.0      # esp32_motors.ino:35


@dataclass(frozen=True)
class Config:
    robot: RobotNetworkConfig = field(default_factory=RobotNetworkConfig)
    sim: SimConfig = field(default_factory=SimConfig)
    sym_walk: SymWalkTaskConfig = field(default_factory=SymWalkTaskConfig)
    terrain: TerrainTaskConfig = field(default_factory=TerrainTaskConfig)
    sb3: SB3TrainConfig = field(default_factory=SB3TrainConfig)
    custom: CustomTrainConfig = field(default_factory=CustomTrainConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)


DEFAULT = Config()
