"""Builds and runs the two C++ firmware simulators of ``native/``.

``firmware_sim`` (the motor-controller ESP32's UDP/JSON protocol and its
500 Hz PID servo) and ``camera_sim`` (the camera ESP32's HTTP endpoints)
are copies of the JAX package's ``native/`` sources.  A binary is built at
first use with ``g++ -O2 -std=c++17 -pthread`` into
``opendog_tpu_torch/_build/native/`` (listed in ``.gitignore``), named after
a hash of its compiler command and source, under a file lock, so that
concurrent processes (test workers) share one build.  The sources' own
``Makefile`` is not used: it writes the binary beside the source.
"""
from __future__ import annotations

import contextlib
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from typing import Iterator, List, Sequence

NATIVE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(NATIVE), "_build", "native")
CXX_FLAGS = ["-O2", "-std=c++17", "-pthread"]
SOURCES = ("firmware_sim", "camera_sim")


def find_gxx() -> str:
    """Path of ``g++``; raises when there is none."""
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ was not found: the firmware simulators "
                           "cannot be built on this machine")
    return path


def build(name: str) -> str:
    """Path of the ``name`` binary (``firmware_sim`` or ``camera_sim``),
    compiled unless a build of the same source and command exists."""
    if name not in SOURCES:
        raise ValueError(f"unknown simulator {name!r}; one of {SOURCES}")
    source = os.path.join(NATIVE, name, f"{name}.cpp")
    cmd = [find_gxx(), *CXX_FLAGS]
    h = hashlib.sha256(" ".join(cmd).encode())
    with open(source, "rb") as f:
        h.update(f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    binary = os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}")
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(binary):
            tmp = f"{binary}.{os.getpid()}.tmp"
            proc = subprocess.run(cmd + ["-o", tmp, source],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"building {name} failed ({' '.join(cmd)})"
                                   f":\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, binary)
    return binary


def stop(procs: Sequence[subprocess.Popen]) -> None:
    """Terminates ``procs`` and waits for them (kills one that does not
    exit within 5 s)."""
    for p in procs:
        p.terminate()
    for p in procs:
        try:
            p.wait(timeout=5)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


@contextlib.contextmanager
def firmware_pair(port1: int, port2: int,
                  telemetry_port: int) -> Iterator[List[subprocess.Popen]]:
    """Two firmware simulators on loopback, standing for the robot's two
    motor ESP32s: commands on ``port1`` / ``port2``, telemetry broadcast to
    ``telemetry_port``.  Both are terminated when the block exits, however
    it exits."""
    binary = build("firmware_sim")
    procs: List[subprocess.Popen] = []
    try:
        for port in (port1, port2):
            procs.append(subprocess.Popen(
                [binary, "--port", str(port), "--telemetry-port",
                 str(telemetry_port)],
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))
        time.sleep(0.3)  # let both bind their ports
        yield procs
    finally:
        stop(procs)


@contextlib.contextmanager
def camera(port: int) -> Iterator[subprocess.Popen]:
    """The camera simulator serving HTTP on ``port``, terminated when the
    block exits."""
    proc = subprocess.Popen([build("camera_sim"), "--port", str(port)],
                            stdout=subprocess.DEVNULL)
    try:
        time.sleep(0.3)
        yield proc
    finally:
        stop([proc])
