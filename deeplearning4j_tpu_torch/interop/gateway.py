"""Keras-backend gateway server (counterpart of
``deeplearning4j_tpu/interop/gateway.py``).

Reference: deeplearning4j-keras/keras/Server.java stands up a Py4J
``GatewayServer(new DeepLearning4jEntryPoint())`` so external Python Keras
drives DL4J as a training backend (entry point fits models from HDF5
batches). Here it is transport-agnostic JSON frames over TCP (no Py4J/JVM):
an external process submits a Keras 1.x model-config JSON, then streams
training batches; the server builds the network on its device (the card
unless it is given ``device="cpu"``), trains it and serves predictions back.

Frame format: uint32 length + JSON. Arrays travel base64(np.save) inside the
JSON — small, dependency-free, and structurally validated on decode.
"""

from __future__ import annotations

import base64
import io
import socket
import threading
from typing import Dict, Optional

import numpy as np

from ..utils.netio import (
    recv_json_frame as _recv_frame,
    send_json_frame as _send_frame,
)


def _encode_array(a: np.ndarray) -> str:
    buf = io.BytesIO()
    np.save(buf, np.ascontiguousarray(a), allow_pickle=False)
    return base64.b64encode(buf.getvalue()).decode()


def _decode_array(s: str) -> np.ndarray:
    return np.load(io.BytesIO(base64.b64decode(s)), allow_pickle=False)


class GatewayServer:
    """Entry point (reference: DeepLearning4jEntryPoint.java).

    Ops: sequential_to_multilayernetwork / fit / predict / evaluate / close.
    One model per session id.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0, device="cuda"):
        from ..nn.multilayer import resolve_device  # noqa: PLC0415

        self.device = resolve_device(device)
        self._models: Dict[str, object] = {}
        self._lock = threading.Lock()
        # per-model locks: concurrent sessions hitting the same model_id
        # serialize their fit/predict/evaluate (the Py4J reference entry
        # point is effectively single-threaded per model)
        self._model_locks: Dict[str, threading.Lock] = {}
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(16)
        self.host, self.port = self._srv.getsockname()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name="dl4j-keras-gateway")
        self._thread.start()

    def shutdown(self) -> None:
        self._stop.set()
        try:
            socket.create_connection((self.host, self.port), timeout=1).close()
        except OSError:
            pass
        self._srv.close()
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()

    # -- dispatch -------------------------------------------------------
    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._session, args=(conn,), daemon=True).start()

    def _session(self, conn: socket.socket) -> None:
        try:
            while True:
                req = _recv_frame(conn)
                if req is None:
                    return
                try:
                    resp = self._dispatch(req)
                except Exception as e:  # error surface to the client
                    resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
                _send_frame(conn, resp)
        except (ConnectionError, OSError):
            pass
        finally:
            conn.close()

    def _dispatch(self, req: dict) -> dict:
        op = req.get("op")
        if op == "sequential_to_multilayernetwork":
            # reference: DeepLearning4jEntryPoint.sequentialToMultilayerNetwork
            from ..modelimport.keras import import_keras_sequential_config  # noqa: PLC0415
            from ..nn.multilayer import MultiLayerNetwork  # noqa: PLC0415

            conf, _ = import_keras_sequential_config(
                req["model_config"], req.get("training_config")
            )
            net = MultiLayerNetwork(conf, device=self.device).init()
            with self._lock:
                self._models[req["model_id"]] = net
                self._model_locks[req["model_id"]] = threading.Lock()
            return {"ok": True, "num_params": net.num_params()}
        model_id = req.get("model_id", "")
        with self._lock:
            net = self._models.get(model_id)
            model_lock = self._model_locks.get(model_id)
        if net is None:
            raise KeyError(f"unknown model_id '{req.get('model_id')}'")
        with model_lock:
            return self._dispatch_model_op(op, req, net, model_id)

    def _dispatch_model_op(self, op: str, req: dict, net, model_id: str) -> dict:
        if op == "fit":
            from ..datasets.iterators import DataSet  # noqa: PLC0415

            x = _decode_array(req["features"])
            y = _decode_array(req["labels"])
            net.fit(DataSet(x, y), epochs=int(req.get("epochs", 1)))
            return {"ok": True, "loss": float(net._last_loss)}
        if op == "predict":
            out = net.output(_decode_array(req["features"]))
            return {"ok": True, "output": _encode_array(np.asarray(out))}
        if op == "evaluate":
            from ..datasets.iterators import DataSet  # noqa: PLC0415

            score = net.score(DataSet(_decode_array(req["features"]),
                                      _decode_array(req["labels"])))
            return {"ok": True, "score": float(score)}
        if op == "close":
            with self._lock:
                self._models.pop(model_id, None)
                self._model_locks.pop(model_id, None)
            return {"ok": True}
        raise ValueError(f"unknown op '{op}'")


class GatewayClient:
    """Client helper for the gateway protocol (what external Keras-side glue
    would implement in its own language)."""

    def __init__(self, host: str, port: int):
        self._sock = socket.create_connection((host, port))

    def _call(self, **req) -> dict:
        _send_frame(self._sock, req)
        resp = _recv_frame(self._sock)
        if resp is None:
            raise ConnectionError("gateway closed")
        if not resp.get("ok"):
            raise RuntimeError(resp.get("error", "gateway error"))
        return resp

    def create_model(self, model_id: str, model_config,
                     training_config: Optional[dict] = None) -> int:
        r = self._call(op="sequential_to_multilayernetwork", model_id=model_id,
                       model_config=model_config, training_config=training_config)
        return r["num_params"]

    def fit(self, model_id: str, features, labels, epochs: int = 1) -> float:
        r = self._call(op="fit", model_id=model_id,
                       features=_encode_array(np.asarray(features)),
                       labels=_encode_array(np.asarray(labels)),
                       epochs=epochs)
        return r["loss"]

    def predict(self, model_id: str, features) -> np.ndarray:
        r = self._call(op="predict", model_id=model_id,
                       features=_encode_array(np.asarray(features)))
        return _decode_array(r["output"])

    def evaluate(self, model_id: str, features, labels) -> float:
        return self._call(op="evaluate", model_id=model_id,
                          features=_encode_array(np.asarray(features)),
                          labels=_encode_array(np.asarray(labels)))["score"]

    def close(self) -> None:
        self._sock.close()
