"""The port's control plane (``dryad_tpu_torch/runtime/protocol.py``,
``interfaces.py``) and its cluster configuration against the JAX
package's, on the CPU: the frames and ``try_decode`` byte for byte, the
HMAC challenge (a port server authenticates a port client and a JAX
client; a wrong secret or a garbage peer is rejected before any pickle
is decoded), the envelope tags, the backend registry, and the
``speculation_*`` / ``farm_task_timeout_s`` fields of
``JobConfig`` with their checks."""

import dataclasses
import socket
import struct
import threading

import pytest

from dryad_tpu.runtime import protocol as jprotocol
from dryad_tpu.utils.config import JobConfig as JJobConfig
from dryad_tpu_torch.runtime import interfaces, protocol
from dryad_tpu_torch.utils.config import JobConfig

FARM_FIELDS = ("speculation_enabled", "speculation_duplication_budget",
                  "speculation_outlier_sigma", "speculation_min_samples",
                  "speculation_rel_margin", "speculation_abs_margin_s",
                  "farm_task_timeout_s")


def _pair():
    a, b = socket.socketpair()
    a.settimeout(5.0)
    b.settimeout(5.0)
    return a, b


# -- frames --------------------------------------------------------------------

MSGS = [{"cmd": "ping", "job": 3}, {"cmd": "run_task", "plan": "{}",
                                    "sources": {"0:0": {"kind": "columns"}},
                                    "task": 7, "config": None},
        {"ok": False, "error": "x" * 5000}, [1, 2.5, b"bytes", None]]


@pytest.mark.parametrize("obj", MSGS, ids=range(len(MSGS)))
def test_frames_decode_across_packages(obj):
    """A frame one package sends decodes in the other, whole or fed one
    byte at a time (``try_decode`` returns None until it is complete)."""
    for send, recv in ((protocol, jprotocol), (jprotocol, protocol)):
        a, b = _pair()
        send.send_msg(a, obj)
        assert recv.recv_msg(b) == obj
        send.send_msg(a, obj)
        n = struct.unpack("<Q", b.recv(8, socket.MSG_PEEK))[0] + 8
        raw = b""
        while len(raw) < n:
            raw += b.recv(n - len(raw))
        buf = bytearray()
        for i in range(len(raw) - 1):
            buf.append(raw[i])
            assert recv.try_decode(buf) is None
        buf.append(raw[-1])
        assert recv.try_decode(buf) == obj and not buf
        a.close()
        b.close()


def test_corrupt_frames_raise_and_drop_the_buffer():
    for bad in (struct.pack("<Q", (4 << 30) + 1) + b"xx",
                struct.pack("<Q", 3) + b"\x80\x04Z"):
        for mod in (protocol, jprotocol):
            buf = bytearray(bad)
            with pytest.raises(mod.FrameError):
                mod.try_decode(buf)
            assert not buf
    a, b = _pair()
    a.sendall(struct.pack("<Q", (4 << 30) + 1))
    with pytest.raises(EOFError, match="oversized"):
        protocol.recv_msg(b)


# -- the HMAC challenge ----------------------------------------------------------


@pytest.mark.parametrize("client_pkg", [protocol, jprotocol],
                         ids=["port", "jax"])
def test_port_server_authenticates_a_client(client_pkg):
    secret = b"s" * 32
    srv, cli = _pair()

    def client():
        client_pkg.client_authenticate(cli, secret)
        client_pkg.send_msg(cli, {"hello": 7})

    t = threading.Thread(target=client)
    t.start()
    assert protocol.server_authenticate(srv, secret)
    assert protocol.recv_msg(srv) == {"hello": 7}
    t.join()


def test_wrong_secret_is_rejected_before_any_pickle():
    srv, cli = _pair()
    done = {}

    def client():
        try:
            protocol.client_authenticate(cli, b"x" * 32)
            done["ok"] = True
        except Exception as e:
            done["err"] = e

    t = threading.Thread(target=client)
    t.start()
    assert not protocol.server_authenticate(srv, b"y" * 32)
    srv.close()
    t.join()
    assert "ok" not in done


def test_garbage_peer_and_wrong_magic_are_rejected():
    """A peer that blasts a pickle frame fails the handshake (its bytes
    are taken as a bogus MAC, never unpickled); a client answering a
    server that is not ours raises AuthError."""
    srv, cli = _pair()
    t = threading.Thread(target=lambda: cli.sendall(b"A" * 64))
    t.start()
    assert not protocol.server_authenticate(srv, b"z" * 32)
    t.join()
    srv, cli = _pair()
    srv.sendall(b"NOPE" + b"\0" * 16)
    with pytest.raises(protocol.AuthError):
        protocol.client_authenticate(cli, b"z" * 32)


def test_none_secret_skips_and_env_secrets(tmp_path, monkeypatch):
    srv, cli = _pair()
    assert protocol.server_authenticate(srv, None)
    protocol.client_authenticate(cli, None)
    monkeypatch.delenv("DRYAD_CONTROL_SECRET", raising=False)
    monkeypatch.delenv("DRYAD_CONTROL_SECRET_FILE", raising=False)
    assert protocol.load_secret_from_env() is None
    monkeypatch.setenv("DRYAD_CONTROL_SECRET", "ab" * 32)
    assert protocol.load_secret_from_env() == bytes.fromhex("ab" * 32)
    monkeypatch.delenv("DRYAD_CONTROL_SECRET")
    f = tmp_path / "sec"
    f.write_text("cd" * 32 + "\n")
    monkeypatch.setenv("DRYAD_CONTROL_SECRET_FILE", str(f))
    assert protocol.load_secret_from_env() == bytes.fromhex("cd" * 32)


# -- envelope tags -----------------------------------------------------------------


def test_envelope_tags_equal_jax():
    for name in ("TRACE_CTX", "JOB_ID", "FORENSICS"):
        assert getattr(protocol, name) == getattr(jprotocol, name)
    for mod in (protocol, jprotocol):
        m = mod.attach_job(mod.attach_trace({}, {"trace": "t"}), 4)
        assert m == {"trace_ctx": {"trace": "t"}, "job": 4}
        assert mod.extract_trace(m) == {"trace": "t"}
        assert mod.extract_trace({"trace_ctx": "junk"}) is None
        assert mod.attach_trace({}, None) == {}
        assert mod.extract_job(m) == 4
        r = mod.attach_forensics({}, {"dryad_forensics": 1, "x": 2})
        assert mod.extract_forensics(r) == {"dryad_forensics": 1, "x": 2}
        assert mod.extract_forensics({"forensics": {"x": 2}}) is None
        assert mod.attach_forensics({}, None) == {}


# -- the backend registry and the configuration ------------------------------------


def test_backend_registry():
    import dryad_tpu_torch.runtime  # noqa: F401  (registers "local")
    assert "local" in interfaces.cluster_backends()

    class Fake(interfaces.ClusterBackend):
        pass

    made = []
    interfaces.register_cluster("Fake", lambda **kw: made.append(kw) or 1)
    try:
        assert interfaces.make_cluster("fake", n_processes=3) == 1
        assert made == [{"n_processes": 3}]
        with pytest.raises(KeyError, match="no cluster backend 'nope'"):
            interfaces.make_cluster("nope")
        with pytest.raises(TypeError):
            Fake()            # abstract: every operation is required
    finally:
        interfaces._FACTORIES.pop("fake", None)


def test_cluster_config_fields_equal_jax():
    port, jax = JobConfig(), JJobConfig()
    for name in FARM_FIELDS:
        assert getattr(port, name) == getattr(jax, name), name
    for bad in ({"speculation_duplication_budget": 1.5},
                {"speculation_min_samples": 0}):
        for cls in (JobConfig, JJobConfig):
            with pytest.raises(ValueError):
                cls(**bad)
    # the gang's and the cluster's fields: the JAX package's names and
    # defaults, every one
    names = {f.name for f in dataclasses.fields(JobConfig)
             if f.name.startswith(("gang_", "cluster_"))}
    jnames = {f.name for f in dataclasses.fields(JJobConfig)
              if f.name.startswith(("gang_", "cluster_"))}
    assert names == jnames
    assert len(names) == 10
    for name in names:
        assert getattr(port, name) == getattr(jax, name), name
    # and their validation
    for bad in ({"cluster_processes": 0},
                {"cluster_devices_per_process": 0},
                {"gang_heartbeat_s": -1.0},
                {"gang_heartbeat_timeout_s": 0.0},
                {"gang_straggler_rel_margin": -0.5},
                {"gang_straggler_abs_margin_s": 0.0}):
        for cls in (JobConfig, JJobConfig):
            with pytest.raises(ValueError):
                cls(**bad)
    ok = {"gang_heartbeat_s": 0.0, "gang_straggler_rel_margin": 0.0,
          "cluster_fn_modules": ("m",)}
    assert JobConfig(**ok).gang_heartbeat_s == JJobConfig(
        **ok).gang_heartbeat_s == 0.0
