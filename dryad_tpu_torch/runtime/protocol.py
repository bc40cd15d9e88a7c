"""Length-prefixed message framing for the driver<->worker control plane
— the port of ``dryad_tpu/runtime/protocol.py``, byte for byte the same
wire format (pure stdlib).

The role of the reference's vertex command protocol (SURVEY.md §2.2 "vertex
commands", ProcessService HTTP endpoints): a tiny, explicit wire format —
8-byte little-endian length + pickled payload.  Pickle executes arbitrary
code on load, so every control connection must FIRST pass the shared-secret
HMAC challenge below before a single pickled byte is decoded: the driver
generates a per-cluster 256-bit secret, hands it to the workers it spawns
out-of-band (process environment locally; a 0600-mode staged file over the
remote shell for SSH deployments — never on a command line), and rejects
any peer that cannot MAC its nonce.  This is what makes binding the
listener on a non-loopback interface sound (the SSH backend,
``runtime/ssh_cluster.py``); the reference's GM<->daemon
channel relies on the cluster security domain the same way
(ProcessService authenticates callers via the cluster's credentials).
"""

from __future__ import annotations

import hmac
import os
import pickle
import socket
import struct
from typing import Any, Optional

_MAGIC = b"DRYD"
_ACK = b"OK01"

# -- trace-context propagation ----------------------------------------------
# Every job/task envelope may carry a TRACE_CTX field: the submitting
# driver span's {"trace": trace_id, "parent": span_id}, adopted by the
# worker for the execution's duration (obs/trace.tracing) so worker-side
# task/stage/io spans parent-link into the driver's trace across the
# process boundary (the Dapper propagation model; the reference's
# Calypso stream carries no causality — SURVEY.md §5 gap).
TRACE_CTX = "trace_ctx"


def attach_trace(msg: dict, ctx) -> dict:
    """Attach a wire trace context to an outgoing envelope (no-op when
    tracing is off and ``ctx`` is None)."""
    if ctx:
        msg[TRACE_CTX] = ctx
    return msg


def extract_trace(msg: dict):
    """Worker side: the envelope's trace context, if any (validated to a
    plain dict — the field rides the pickle channel but is inert data)."""
    ctx = msg.get(TRACE_CTX)
    return ctx if isinstance(ctx, dict) else None


# -- job namespacing ---------------------------------------------------------
# Every job/task envelope and every reply carries a JOB tag: workers echo
# it verbatim, schedulers discard stale frames by it (runtime/cluster.py
# _decode_job_frames), and the multi-tenant service daemon routes frames
# from MANY concurrent jobs sharing one fleet back to the right per-job
# driver state by it (service/daemon.py).  One constant + two helpers so
# every attach/read site names the same field.
JOB_ID = "job"


def attach_job(msg: dict, job) -> dict:
    """Tag an outgoing envelope with its job id (in place; returns msg)."""
    msg[JOB_ID] = job
    return msg


def extract_job(msg: dict):
    """The envelope/reply's job tag, or None."""
    return msg.get(JOB_ID)


# -- failure forensics -------------------------------------------------------
# A failing worker's error reply may carry a FORENSICS field: the flight
# recorder's self-contained bundle (obs/flight.py — task envelope, input
# digests, exception, recent-event ring) for driver-side persistence and
# `python -m dryad_tpu_torch.obs replay` local reproduction.
FORENSICS = "forensics"


def attach_forensics(reply: dict, bundle) -> dict:
    """Attach a forensics bundle to an error reply (no-op on None)."""
    if bundle:
        reply[FORENSICS] = bundle
    return reply


def extract_forensics(reply: dict):
    """Driver side: the reply's forensics bundle, if it carries a valid
    one (obs/flight.py magic key — anything else is ignored)."""
    b = reply.get(FORENSICS)
    return b if isinstance(b, dict) and b.get("dryad_forensics") else None


class AuthError(RuntimeError):
    """Control-plane handshake failed (wrong secret or not our protocol)."""


def server_authenticate(conn: socket.socket, secret: Optional[bytes],
                        timeout: float = 10.0) -> bool:
    """Challenge an accepted control connection BEFORE any unpickling.

    Sends a random nonce, requires HMAC-SHA256(secret, nonce) back, acks.
    Returns False (caller closes the socket) on mismatch, timeout, or a
    peer that does not speak the handshake.  ``secret=None`` (explicitly
    configured trust, e.g. single-machine loopback tests) skips the
    challenge."""
    if secret is None:
        return True
    nonce = os.urandom(16)
    prev = conn.gettimeout()
    try:
        conn.settimeout(timeout)
        conn.sendall(_MAGIC + nonce)
        mac = _recv_exact(conn, 32)
        want = hmac.new(secret, nonce, "sha256").digest()
        if not hmac.compare_digest(want, mac):
            return False
        conn.sendall(_ACK)
        return True
    except (OSError, EOFError):
        return False
    finally:
        try:
            conn.settimeout(prev)
        except OSError:
            pass


def client_authenticate(sock: socket.socket, secret: Optional[bytes]
                        ) -> None:
    """Answer the driver's HMAC challenge (worker side); raises AuthError
    on a protocol mismatch or rejected MAC."""
    if secret is None:
        return
    hdr = _recv_exact(sock, len(_MAGIC) + 16)
    if hdr[:len(_MAGIC)] != _MAGIC:
        raise AuthError("control peer did not send an auth challenge")
    sock.sendall(hmac.new(secret, hdr[len(_MAGIC):], "sha256").digest())
    if _recv_exact(sock, len(_ACK)) != _ACK:
        raise AuthError("driver rejected control-plane credentials")


def load_secret_from_env() -> Optional[bytes]:
    """Worker-side secret source: DRYAD_CONTROL_SECRET (hex, set in the
    spawned process environment by the local backend) or
    DRYAD_CONTROL_SECRET_FILE (path to a 0600 staged file, SSH backend)."""
    h = os.environ.get("DRYAD_CONTROL_SECRET")
    if h:
        return bytes.fromhex(h.strip())
    p = os.environ.get("DRYAD_CONTROL_SECRET_FILE")
    if p:
        with open(p) as f:
            return bytes.fromhex(f.read().strip())
    return None

_LEN = struct.Struct("<Q")
# control messages are plans + host source columns; cap frames at 4 GiB to
# fail fast on corruption rather than allocating garbage lengths
_MAX_FRAME = 4 << 30


def send_msg(sock: socket.socket, obj: Any) -> None:
    data = pickle.dumps(obj, protocol=4)
    sock.sendall(_LEN.pack(len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        b = sock.recv(min(n, 1 << 20))
        if not b:
            raise EOFError("peer closed control connection")
        chunks.append(b)
        n -= len(b)
    return b"".join(chunks)


def recv_msg(sock: socket.socket) -> Any:
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    if n > _MAX_FRAME:
        raise EOFError(f"oversized control frame ({n} bytes)")
    return pickle.loads(_recv_exact(sock, n))


class FrameError(RuntimeError):
    """The byte stream is desynced from the framing — unrecoverable."""


def try_decode(buf: bytearray) -> Any:
    """Decode one frame from an accumulation buffer if complete, else None.

    The non-blocking sibling of recv_msg — ONE place owns the wire format.
    A length beyond _MAX_FRAME or an undecodable payload means the stream
    lost framing; the poisoned bytes are dropped (so a persistent buffer
    cannot re-raise on the next decode) and FrameError is raised."""
    if len(buf) < _LEN.size:
        return None
    (n,) = _LEN.unpack_from(buf, 0)
    if n > _MAX_FRAME:
        del buf[:]
        raise FrameError(f"corrupt control frame: length {n} exceeds "
                         f"{_MAX_FRAME} byte cap")
    if len(buf) < _LEN.size + n:
        return None
    try:
        obj = pickle.loads(bytes(buf[_LEN.size:_LEN.size + n]))
    except Exception as e:
        del buf[:]
        raise FrameError(f"corrupt control frame payload: {e!r}")
    del buf[:_LEN.size + n]
    return obj
