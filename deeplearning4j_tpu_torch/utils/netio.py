"""Socket framing helpers (counterpart of ``deeplearning4j_tpu/utils/netio.py``):
read-exactly-n plus length-prefixed array/JSON frames, used by the
streaming socket transport."""

from __future__ import annotations

import json
import socket
import struct
from typing import Optional

import numpy as np

# Length prefixes come from an unauthenticated peer — cap them so a hostile
# or corrupt frame can't force a multi-GB allocation (memory-exhaustion DoS).
MAX_ARRAY_BYTES = 256 * 1024 * 1024  # a 64M-param float32 vector
MAX_JSON_BYTES = 16 * 1024 * 1024


class FrameTooLargeError(ConnectionError):
    """Peer announced a frame exceeding the configured cap."""


def _check_frame(n: int, cap: int, kind: str) -> None:
    if n > cap:
        raise FrameTooLargeError(f"{kind} frame of {n} bytes exceeds cap {cap}")


def recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


def send_array(sock: socket.socket, arr: np.ndarray) -> None:
    payload = np.ascontiguousarray(arr, dtype=np.float32).tobytes()
    sock.sendall(struct.pack(">Q", len(payload)) + payload)


def recv_array(sock: socket.socket, max_bytes: int = MAX_ARRAY_BYTES) -> np.ndarray:
    (n,) = struct.unpack(">Q", recv_exact(sock, 8))
    _check_frame(n, max_bytes, "array")
    return np.frombuffer(recv_exact(sock, n), dtype=np.float32).copy()


def send_json_frame(sock: socket.socket, obj: dict) -> None:
    payload = json.dumps(obj).encode()
    sock.sendall(struct.pack(">I", len(payload)) + payload)


def recv_json_frame(
    sock: socket.socket, max_bytes: int = MAX_JSON_BYTES
) -> Optional[dict]:
    """None on orderly close before/inside a frame; raises FrameTooLargeError
    (a ConnectionError — callers should drop the connection) on oversize."""
    try:
        header = recv_exact(sock, 4)
    except ConnectionError:
        return None
    (n,) = struct.unpack(">I", header)
    _check_frame(n, max_bytes, "json")
    try:
        return json.loads(recv_exact(sock, n))
    except ConnectionError:
        return None
