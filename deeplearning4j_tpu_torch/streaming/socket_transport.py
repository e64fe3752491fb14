"""Cross-process record transport for the streaming tier: TCP sink/source
(counterpart of ``deeplearning4j_tpu/streaming/socket_transport.py``).

Reference: dl4j-streaming moves records between producer and training/
serving JVMs through Kafka — ``NDArrayKafkaClient`` publishes ndarrays to a
topic, ``BaseKafkaPipeline`` consumes them into DataSets
(dl4j-streaming/.../kafka/NDArrayKafkaClient.java, BaseKafkaPipeline.java).
This module is the same seam with zero external deps: a length-prefixed TCP
stream (the framing of utils/netio.py)
carries (features[, label]) records from any number of producer processes
into one ``SocketRecordSource``, which plugs into ``StreamingPipeline``
exactly like the in-process ``QueueSource``. A broker-backed transport
(``KafkaSource``) remains available for deployments that have one; the
design difference vs the reference is that the transport is an SPI seam
(``RecordSource``) rather than a hard Camel/Kafka dependency.

Wire format per record: one JSON frame ``{"f": feature_shape, "l":
label_shape | null}`` followed by the feature array frame and, when
labelled, the label array frame (float32, C-order — netio framing).
"""

from __future__ import annotations

import queue
import socket
import threading
from typing import List, Optional, Tuple

import numpy as np

from ..utils.netio import (
    recv_array,
    recv_json_frame,
    send_array,
    send_json_frame,
)
from .pipeline import RecordSource


class SocketRecordSource(RecordSource):
    """Listening end: accepts producer connections, reads record frames into
    a bounded queue served by ``poll`` (the ``BaseKafkaPipeline`` consumer
    role). Start before producers connect; ``port=0`` picks a free port
    (read it back from ``.port``)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 maxsize: int = 4096, backlog: int = 16):
        self._q: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self._stop = threading.Event()
        self._server = socket.create_server((host, port), backlog=backlog)
        self._server.settimeout(0.2)
        self.host, self.port = self._server.getsockname()[:2]
        self._readers: List[threading.Thread] = []
        self._conns: List[socket.socket] = []
        self._registry_lock = threading.Lock()  # guards the two lists above
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="record-source-accept"
        )
        self._accept_thread.start()

    # -- server side ---------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._server.accept()
            except socket.timeout:
                continue
            except OSError:  # closed under us during shutdown
                return
            t = threading.Thread(target=self._read_loop, args=(conn,),
                                 daemon=True, name="record-source-reader")
            with self._registry_lock:
                self._conns.append(conn)  # close() closes these to unblock recv
                self._readers.append(t)
            t.start()

    @staticmethod
    def _shaped(arr, shape) -> "np.ndarray":
        """Protocol check: a size/shape mismatch is a framing error from a
        buggy or version-skewed producer — drop the CONNECTION loudly, not
        the reader thread silently."""
        expected = 1
        for d in shape:
            expected *= int(d)
        if arr.size != expected:
            raise ConnectionError(
                f"record frame mismatch: payload {arr.size} elements, "
                f"header shape {shape}"
            )
        return arr.reshape(shape)

    def _read_loop(self, conn: socket.socket) -> None:
        try:
            with conn:
                while not self._stop.is_set():
                    header = recv_json_frame(conn)
                    if header is None:  # orderly close from the producer
                        return
                    feats = self._shaped(recv_array(conn), header["f"])
                    label = None
                    if header.get("l") is not None:
                        label = self._shaped(recv_array(conn), header["l"])
                    while not self._stop.is_set():
                        try:
                            self._q.put((feats, label), timeout=0.2)
                            break
                        except queue.Full:
                            continue
        except (ConnectionError, OSError):
            # dropped/misbehaving producer (or close() closed the socket
            # under us): records delivered before the break survive
            return
        finally:
            # a long-lived source with churning producers must not
            # accumulate dead sockets/threads without bound
            with self._registry_lock:
                if conn in self._conns:
                    self._conns.remove(conn)
                me = threading.current_thread()
                if me in self._readers:
                    self._readers.remove(me)

    # -- RecordSource --------------------------------------------------
    def poll(self, timeout: float = 0.1):
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    def close(self) -> None:
        self._stop.set()
        try:
            self._server.close()
        except OSError:
            pass
        with self._registry_lock:
            conns, readers = list(self._conns), list(self._readers)
        for c in conns:         # unblocks readers parked in recv: close()
            try:                # alone does not wake a blocked recv — the
                c.shutdown(socket.SHUT_RDWR)  # FIN/reset from shutdown does
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        self._accept_thread.join(timeout=5)
        for t in readers:
            t.join(timeout=5)


class SocketRecordSink:
    """Producer end: connects to a ``SocketRecordSource`` and publishes
    records (the ``NDArrayKafkaClient`` role). Safe for one thread per sink;
    open one sink per producer thread/process."""

    def __init__(self, host: str, port: int, timeout: float = 30.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._sock.settimeout(timeout)
        self._lock = threading.Lock()

    def put(self, features, label=None) -> None:
        feats = np.asarray(features, np.float32)
        lab = None if label is None else np.asarray(label, np.float32)
        with self._lock:
            send_json_frame(self._sock, {
                "f": list(feats.shape),
                "l": None if lab is None else list(lab.shape),
            })
            send_array(self._sock, feats)
            if lab is not None:
                send_array(self._sock, lab)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self) -> "SocketRecordSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def serve_records(host: str, port: int,
                  records: List[Tuple[np.ndarray, Optional[np.ndarray]]]) -> None:
    """Convenience producer: publish ``records`` to a source and close
    (what a producer process's main() typically does)."""
    with SocketRecordSink(host, port) as sink:
        for feats, label in records:
            sink.put(feats, label)
