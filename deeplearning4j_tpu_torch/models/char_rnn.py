"""Char-RNN: stacked GravesLSTM language model (counterpart of
``deeplearning4j_tpu/models/char_rnn.py``): the same layers and settings
(Adam, TBPTT), a JSON config that either package reads, and the same
``CharIterator``."""

from __future__ import annotations

import numpy as np

from ..datasets.iterators import DataSet
from ..nn.conf.inputs import InputType
from ..nn.conf.multi_layer import MultiLayerConfiguration
from ..nn.layers.recurrent import GravesLSTM, RnnOutputLayer
from ..nn.updaters import UpdaterConfig


def char_rnn(
    vocab_size: int,
    hidden_size: int = 256,
    num_layers: int = 2,
    tbptt_length: int = 50,
    learning_rate: float = 1e-3,
    dtype: str = "float32",
    seed: int = 12345,
) -> MultiLayerConfiguration:
    """Stacked-LSTM character model over one-hot inputs [B, T, vocab]."""
    layers = [
        GravesLSTM(n_in=vocab_size if i == 0 else hidden_size,
                   n_out=hidden_size, activation="tanh")
        for i in range(num_layers)
    ]
    layers.append(RnnOutputLayer(n_in=hidden_size, n_out=vocab_size,
                                 activation="softmax", loss="mcxent"))
    return MultiLayerConfiguration(
        layers=layers,
        input_type=InputType.recurrent(vocab_size),
        updater=UpdaterConfig(updater="adam", learning_rate=learning_rate).to_dict(),
        backprop_type="tbptt",
        tbptt_fwd_length=tbptt_length,
        tbptt_back_length=tbptt_length,
        dtype=dtype,
        seed=seed,
    )


class CharIterator:
    """Text -> one-hot next-char-prediction minibatches: yields DataSets of
    features [B, T, V] and labels [B, T, V] shifted by one character."""

    def __init__(self, text: str, seq_length: int = 50, batch_size: int = 32,
                 seed: int = 0):
        self.chars = sorted(set(text))
        self.char_to_idx = {c: i for i, c in enumerate(self.chars)}
        self.vocab_size = len(self.chars)
        self.encoded = np.array([self.char_to_idx[c] for c in text], dtype=np.int32)
        self.seq_length = seq_length
        self.batch_size = batch_size
        self._rng = np.random.default_rng(seed)
        self.reset()

    def reset(self):
        n_seq = (len(self.encoded) - 1) // self.seq_length
        self._starts = self._rng.permutation(n_seq) * self.seq_length
        self._pos = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self._pos + self.batch_size > len(self._starts):
            raise StopIteration
        starts = self._starts[self._pos : self._pos + self.batch_size]
        self._pos += self.batch_size
        T, V = self.seq_length, self.vocab_size
        x = np.zeros((len(starts), T, V), dtype=np.float32)
        y = np.zeros((len(starts), T, V), dtype=np.float32)
        for b, s in enumerate(starts):
            seq = self.encoded[s : s + T + 1]
            x[b, np.arange(T), seq[:-1]] = 1.0
            y[b, np.arange(T), seq[1:]] = 1.0
        return DataSet(x, y)
