"""Convolutional activation rendering listener (counterpart of
``deeplearning4j_tpu/ui/conv_listener.py``).

Reference: deeplearning4j-ui legacy ConvolutionalIterationListener.java +
the Play ConvolutionalListenerModule — every N iterations the first conv
layer's feature maps for one input are rendered into the dashboard. The
JVM version paints a PNG server-side; here the maps are downsampled,
normalized grids in the update record and the browser draws them as SVG
(ui/server.py /train/activations).
"""

from __future__ import annotations

import time
import uuid
from typing import Optional

import numpy as np

from ..optimize.listeners import TrainingListener
from .storage import StatsStorageRouter


def _downsample(img: np.ndarray, max_px: int) -> np.ndarray:
    h, w = img.shape
    # ceil stride: cover the WHOLE map (floor would crop maps between
    # max_px+1 and 2*max_px-1 to their top-left corner)
    sh, sw = -(-h // max_px), -(-w // max_px)
    return img[::max(1, sh), ::max(1, sw)][:max_px, :max_px]


class ConvolutionalIterationListener(TrainingListener):
    """Capture first-conv-layer feature maps every ``frequency`` iterations."""

    # models check this to retain the current batch for re-forwarding
    needs_input = True

    def __init__(
        self,
        router: StatsStorageRouter,
        frequency: int = 10,
        session_id: Optional[str] = None,
        worker_id: str = "0",
        max_maps: int = 16,
        max_px: int = 16,
    ):
        self.router = router
        self.frequency = max(1, frequency)
        self.session_id = session_id or f"session_{uuid.uuid4().hex[:8]}"
        self.worker_id = worker_id
        self.max_maps = max_maps
        self.max_px = max_px

    def iteration_done(self, model, iteration: int, score) -> None:
        if iteration % self.frequency:
            return
        x = getattr(model, "_last_input", None)
        if x is None or not hasattr(model, "feed_forward"):
            return
        # the batch's first example (a host array or a card tensor, as fit
        # got it); feed_forward returns host arrays
        acts = model.feed_forward(x[:1])
        conv_acts = [(i, a) for i, a in enumerate(acts) if np.ndim(a) == 4]
        if not conv_acts:
            return
        layer_idx, a = conv_acts[0]  # first conv/pool output, NHWC
        a = np.asarray(a[0], dtype=np.float32)  # [H, W, C]
        maps = []
        for c in range(min(a.shape[-1], self.max_maps)):
            m = _downsample(a[:, :, c], self.max_px)
            lo, hi = float(m.min()), float(m.max())
            if hi > lo:
                m = (m - lo) / (hi - lo)
            else:
                m = np.zeros_like(m)
            maps.append(np.round(m, 3).tolist())
        self.router.put_update({
            "session_id": self.session_id,
            "worker_id": self.worker_id,
            "timestamp": time.time(),
            "iteration": iteration,
            "score": float(score),
            "conv_activations": {"layer": layer_idx, "maps": maps},
        })


def post_tsne(router: StatsStorageRouter, session_id: str,
              coords, labels=None) -> None:
    """Publish 2-D t-SNE coordinates to the dashboard's t-SNE page
    (reference: the Play tsne module renders uploaded coordinate files;
    plot/tsne.py output plugs straight in)."""
    coords = np.asarray(coords, dtype=np.float64)
    if coords.ndim != 2 or coords.shape[1] < 2:
        raise ValueError(f"coords must be [N, 2+], got {coords.shape}")
    record = {
        "session_id": session_id,
        "worker_id": "tsne",
        "timestamp": time.time(),
        "tsne": {
            "coords": np.round(coords[:, :2], 4).tolist(),
            "labels": [str(l) for l in labels] if labels is not None else None,
        },
    }
    router.put_static_info(record)
