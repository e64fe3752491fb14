"""Load any supported model artifact by sniffing (counterpart of
``deeplearning4j_tpu/utils/model_guesser.py``; reference:
util/ModelGuesser.java).

The reference tries MultiLayerNetwork, then ComputationGraph, then bare conf
JSON. Keras HDF5 archives are recognized too (the modelimport tier).
"""

from __future__ import annotations

import json
import os
import zipfile
from typing import Any

from ..nn.multilayer import resolve_device


def guess_model(path: str, device="cuda") -> Any:
    """Return a model (MultiLayerNetwork/ComputationGraph, on ``device``) or
    a configuration.

    Order: our zip checkpoint → Keras HDF5 → conf JSON (MultiLayer then
    ComputationGraph) — mirrors ModelGuesser.loadModelGuess.
    """
    resolve_device(device)
    if not os.path.exists(path):
        raise FileNotFoundError(path)

    if zipfile.is_zipfile(path):
        from .serialization import restore_model  # noqa: PLC0415

        return restore_model(path, device=device)

    with open(path, "rb") as f:
        magic = f.read(8)
    if magic.startswith(b"\x89HDF\r\n\x1a\n"):
        from ..modelimport.keras import import_keras_model_and_weights  # noqa: PLC0415

        return import_keras_model_and_weights(path, enforce_training_config=False,
                                              device=device)

    # conf JSON
    with open(path) as f:
        text = f.read()
    d = json.loads(text)
    from ..nn.conf.computation_graph import ComputationGraphConfiguration  # noqa: PLC0415
    from ..nn.conf.multi_layer import MultiLayerConfiguration  # noqa: PLC0415

    if "vertices" in d:
        return ComputationGraphConfiguration.from_dict(d)
    return MultiLayerConfiguration.from_dict(d)
