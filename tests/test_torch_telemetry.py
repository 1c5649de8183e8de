"""The port's telemetry (``opendog_tpu_torch/telemetry``) against the JAX
package's: the plain-Python msgpack encoder equals ``msgpack.packb(...,
use_bin_type=True)`` byte for byte (msgpack is imported in this test only;
the port never imports it), each package's client reads the other's server
on loopback with equal dicts, and the force scope mirrors
``tests/test_scope_imu.py``."""
import time

import msgpack
import numpy as np
import pytest
import torch

from opendog_tpu import telemetry as jtel
from opendog_tpu_torch import telemetry as ttel
from opendog_tpu_torch.telemetry import wire

torch.set_num_threads(1)


def _packet(rng, module):
    return module.simulation_packet(
        float(rng.uniform(0, 100)), rng.normal(size=15), rng.normal(size=14),
        rng.normal(size=int(rng.integers(8, 13))),
        rng.normal(0, 20, size=(4, 3)), int(rng.integers(0, 40)))


@pytest.mark.parametrize("seed", range(6))
def test_encoder_equals_msgpack_on_simulation_packets(seed):
    rng = np.random.default_rng(seed)
    pkt = _packet(rng, ttel)
    assert pkt == _packet(np.random.default_rng(seed), jtel)
    data = wire.dumps(pkt)
    assert data == msgpack.packb(pkt, use_bin_type=True)
    assert wire.loads(data) == msgpack.unpackb(data, raw=False) == pkt


@pytest.mark.parametrize("obj", [
    None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1,
    2**32, 2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2**31,
    -2**31 - 1, -2**63, 0.0, -1.5, 1e300, float("inf"), "", "a" * 31,
    "b" * 32, "é" * 200, "c" * 70000, b"", b"\x00" * 300, list(range(15)),
    list(range(16)), list(range(70000)), {str(i): i for i in range(15)},
    {str(i): [i, {"x": None}] for i in range(16)},
    {"nested": {"deep": [1.25, [True, False, None], "s"]}},
])
def test_encoder_equals_msgpack_at_every_size_class(obj):
    data = wire.dumps(obj)
    assert data == msgpack.packb(obj, use_bin_type=True)
    assert wire.loads(data) == msgpack.unpackb(data, raw=False)


def test_decoder_rejects_cut_and_padded_data():
    data = wire.dumps({"qpos": [1.0, 2.0]})
    with pytest.raises(ValueError):
        wire.loads(data[:-3])
    with pytest.raises(ValueError):
        wire.loads(data + b"\x00")


def _read_one(client, tries=40):
    for _ in range(tries):
        p = client.recv()
        if p is not None:
            return p
    return None


@pytest.mark.parametrize("server_pkg,client_pkg", [(jtel, ttel),
                                                   (ttel, jtel)])
def test_client_reads_the_other_packages_server(server_pkg, client_pkg):
    pkt = _packet(np.random.default_rng(7), jtel)
    server = server_pkg.TelemetryServer(lambda: pkt, host="127.0.0.1",
                                        port=0, rate_hz=100.0).start_server()
    client = client_pkg.TelemetryClient("127.0.0.1", server.port,
                                        timeout=0.5)
    try:
        deadline = time.time() + 10.0
        got = None
        while got is None and time.time() < deadline:
            client.connect()
            got = _read_one(client, tries=2)
        assert got == pkt
        assert _read_one(client) == pkt
    finally:
        client.close()
        server.stop()


def test_force_scope_roll_semantics():
    scope = ttel.ForceScope(buffer_size=5)
    for i in range(7):
        scope.update([i, 10 + i, 20 + i, 30 + i])
    np.testing.assert_allclose(scope.data[0], [2, 3, 4, 5, 6])
    np.testing.assert_allclose(scope.data[3], [32, 33, 34, 35, 36])
    assert scope.n_samples == 7


def test_force_scope_watches_packet_stream_as_jax(tmp_path):
    """tests/test_scope_imu.py's stream through both scopes: the same
    buffers, the same terminal frame."""
    forces = [[[0, 0, 4.0 + i], [0, 0, 5.0], [0, 0, 5.0], [0, 0, 5.2]]
              for i in range(10)]
    scopes = []
    for pkg in (ttel, jtel):
        pkts = [pkg.simulation_packet(0.1, np.zeros(15), np.zeros(14),
                                      np.zeros(8), np.asarray(f, float), 4)
                for f in forces]
        frames = []
        scopes.append(pkg.watch(iter(pkts), scope=pkg.ForceScope(8),
                                on_frame=lambda s: frames.append(
                                    s.data[0, -1]), max_packets=10))
        assert len(frames) == 10
    mine, theirs = scopes
    np.testing.assert_array_equal(mine.data, theirs.data)
    assert mine.data[0, -1] == 13.0 and mine.data[3, -1] == 5.2
    assert mine.render_terminal(width=8) == theirs.render_terminal(width=8)
    out = mine.render_png(str(tmp_path / "scope.png"))
    assert out.endswith("scope.png")
    assert (tmp_path / "scope.png").stat().st_size > 1000
