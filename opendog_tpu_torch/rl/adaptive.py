"""Adaptive hyperparameter scheduler — behavioural port of the reference's
reward-trend controller (``sim2real/train.py:55-63,571-586``).  A copy of
the JAX package's JAX-free ``rl/adaptive.py``.

Every ``check_interval`` episodes it compares the first and second half of a
short average-reward history:
  * worsening  -> lr x0.75, entropy x0.9, action log-std shrunk by log(1.05)
  * stagnant   -> entropy x1.05, log-std grown by log(1.03), lr x1.05 when
                  far below max
  * improving  -> lr x0.95 (gentle decay)
all clamped to the reference bounds.  Host-side (cheap, episodic); the
resulting lr / entropy coef feed the trainer between chunks and the
log-std bound is applied to the parameters between chunks.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field

MIN_LR, MAX_LR = 1e-6, 3e-4
MIN_ENT, MAX_ENT = 0.0001, 0.01
MIN_LOG_STD = math.log(0.10)
MAX_LOG_STD = math.log(0.5)


@dataclass
class AdaptiveState:
    lr: float = 1e-4               # INITIAL_LEARNING_RATE
    ent_coef: float = 0.002        # INITIAL_ENTROPY_COEF
    log_std_shift: float = 0.0     # cumulative shift to apply to log_std
    check_interval: int = 10       # ADAPTATION_CHECK_INTERVAL
    history_len: int = 5           # AVGR_HISTORY_LEN
    episode_rewards: deque = field(default_factory=lambda: deque(maxlen=100))
    avg_history: deque = field(default_factory=lambda: deque(maxlen=5))
    episodes_seen: int = 0

    def record_episode(self, episode_reward: float):
        self.episode_rewards.append(float(episode_reward))
        avg = sum(self.episode_rewards) / len(self.episode_rewards)
        self.avg_history.append(avg)
        self.episodes_seen += 1
        shift = 0.0
        if (
            self.episodes_seen % self.check_interval == 0
            and len(self.avg_history) >= self.history_len
        ):
            h = list(self.avg_history)
            half = self.history_len // 2
            first, second = h[:half], h[half:]
            trend = sum(second) / len(second) - sum(first) / len(first)
            current = h[-1]
            thresh = 0.10 * abs(current) if abs(current) > 10 else 1.0
            if trend < -thresh:  # worsening
                self.lr = max(MIN_LR, self.lr * 0.75)
                self.ent_coef = max(MIN_ENT, self.ent_coef * 0.9)
                shift = -math.log(1.05)
            elif abs(trend) < thresh * 0.3:  # stagnant
                self.ent_coef = min(MAX_ENT, self.ent_coef * 1.05)
                shift = math.log(1.03)
                if self.lr < MAX_LR * 0.1:
                    self.lr = min(MAX_LR, self.lr * 1.05)
            elif trend > thresh:  # improving
                if self.lr > MIN_LR * 5:
                    self.lr = max(MIN_LR, self.lr * 0.95)
        return shift

    @staticmethod
    def clamp_log_std(log_std_value: float, shift: float) -> float:
        return min(MAX_LOG_STD, max(MIN_LOG_STD, log_std_value + shift))
