"""Voice-controlled gait state machine.

Port of the command layer of ``Code/examples/udp_voice.py`` +
``voice_detect.py``: Spanish activation word "perrito" and the command
vocabulary camina / para / derecha / izquierda / párate / siéntate /
agáchate / apágate mapped onto the walk/turn/pose state machine
(udp_voice.py:248-325).  Whisper streaming transcription is gated behind an
optional import (the model download needs network); the parser and state
machine are pure and fully tested offline.

A copy of the JAX package's ``apps/voice.py`` (which imports no JAX).
"""
from __future__ import annotations

import enum
import unicodedata
from dataclasses import dataclass
from typing import Optional


class RobotCommand(enum.Enum):
    WALK = "camina"
    STOP = "para"
    RIGHT = "derecha"
    LEFT = "izquierda"
    STAND = "parate"
    SIT = "sientate"
    CROUCH = "agachate"
    SHUTDOWN = "apagate"


ACTIVATION_WORD = "perrito"  # udp_voice.py activation


def _normalize(text: str) -> str:
    return (
        unicodedata.normalize("NFD", text.lower())
        .encode("ascii", "ignore")
        .decode()
    )


def parse_command(transcript: str,
                  require_activation: bool = True) -> Optional[RobotCommand]:
    """Extract the first recognised command from a transcript; None when the
    activation word is missing (udp_voice.py:248-270)."""
    t = _normalize(transcript)
    if require_activation and ACTIVATION_WORD not in t:
        return None
    # longest-match-first so "parate" wins over its substring "para"
    for cmd in sorted(RobotCommand, key=lambda c: -len(c.value)):
        if cmd.value in t:
            return cmd
    return None


class GaitMode(enum.Enum):
    IDLE = "IDLE"
    WALKING = "WALKING"
    TURNING_RIGHT = "TURNING_RIGHT"
    TURNING_LEFT = "TURNING_LEFT"
    SITTING = "SITTING"
    CROUCHING = "CROUCHING"
    SHUTDOWN = "SHUTDOWN"


@dataclass
class VoiceGaitMachine:
    """Command -> gait-mode transitions (udp_voice.py:272-325)."""

    mode: GaitMode = GaitMode.IDLE
    turn_offset_deg: float = 30.0

    def apply(self, cmd: Optional[RobotCommand]) -> GaitMode:
        if cmd is None:
            return self.mode
        if cmd == RobotCommand.WALK:
            self.mode = GaitMode.WALKING
        elif cmd == RobotCommand.STOP or cmd == RobotCommand.STAND:
            self.mode = GaitMode.IDLE
        elif cmd == RobotCommand.RIGHT:
            self.mode = GaitMode.TURNING_RIGHT
        elif cmd == RobotCommand.LEFT:
            self.mode = GaitMode.TURNING_LEFT
        elif cmd == RobotCommand.SIT:
            self.mode = GaitMode.SITTING
        elif cmd == RobotCommand.CROUCH:
            self.mode = GaitMode.CROUCHING
        elif cmd == RobotCommand.SHUTDOWN:
            self.mode = GaitMode.SHUTDOWN
        return self.mode

    def target_yaw_delta(self) -> float:
        if self.mode == GaitMode.TURNING_RIGHT:
            return -self.turn_offset_deg
        if self.mode == GaitMode.TURNING_LEFT:
            return self.turn_offset_deg
        return 0.0


def make_transcriber(model_name: str = "small", language: str = "es"):
    """Optional Whisper transcriber (voice_detect.py).  Raises ImportError
    when whisper isn't installed — callers should degrade to text input."""
    import whisper  # gated: not in the base image

    model = whisper.load_model(model_name)

    def transcribe(audio) -> str:
        return model.transcribe(audio, language=language)["text"]

    return transcribe
