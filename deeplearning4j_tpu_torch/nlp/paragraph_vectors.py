"""ParagraphVectors (doc2vec) facade (counterpart of
``deeplearning4j_tpu/nlp/paragraph_vectors.py``).

Reference: models/paragraphvectors/ParagraphVectors.java (1,380 LoC) — labels
are vocabulary rows trained by the DBOW/DM sequence algorithms
(embeddings/learning/impl/sequence/DBOW.java, DM.java); inference of unseen
documents re-runs the training step on a fresh row with the tables frozen:
``infer_vector`` takes the JAX module's generator (``default_rng(seed)``),
steps and learning rate, and its gradient in closed form on the model's
device, the frozen rows it reads gathered on the host.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .sentence_iterator import LabelledDocument
from .sequence_vectors import Sequence, SequenceVectors
from .tokenization import DefaultTokenizerFactory, TokenizerFactory


class ParagraphVectors(SequenceVectors):
    def __init__(self, *, tokenizer_factory: Optional[TokenizerFactory] = None,
                 sequence_algo: str = "dbow", train_elements: bool = False, **kwargs):
        kwargs.setdefault("elements_algo", "skipgram" if train_elements else "none")
        super().__init__(
            sequence_algo=sequence_algo, train_elements=train_elements, **kwargs
        )
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()

    def _docs_to_sequences(self, docs) -> List[Sequence]:
        out = []
        for d in docs:
            if isinstance(d, LabelledDocument):
                toks = self.tokenizer_factory.create(d.content).get_tokens()
                out.append(Sequence(elements=toks, labels=list(d.labels)))
            elif isinstance(d, Sequence):
                out.append(d)
            else:
                raise TypeError(f"expected LabelledDocument/Sequence, got {type(d)}")
        return out

    def fit_documents(self, docs) -> "ParagraphVectors":
        return self.fit(self._docs_to_sequences(docs))

    def fit(self, data) -> "ParagraphVectors":
        data = list(data)
        if data and isinstance(data[0], LabelledDocument):
            data = self._docs_to_sequences(data)
        return super().fit(data)

    # ---- queries ----
    def get_label_vector(self, label: str) -> Optional[np.ndarray]:
        return self.lookup.vector(label)

    def similarity_to_label(self, text: str, label: str) -> float:
        v = self.infer_vector(text)
        lv = self.get_label_vector(label)
        denom = np.linalg.norm(v) * np.linalg.norm(lv)
        return float(v @ lv / denom) if denom > 0 else 0.0

    def predict(self, text: str) -> Optional[str]:
        """Nearest label for an unseen document (reference:
        ParagraphVectors.predict)."""
        labels = [vw.word for vw in self.vocab.vocab_words() if vw.is_label]
        if not labels:
            return None
        v = self.infer_vector(text)
        best, best_sim = None, -np.inf
        for lab in labels:
            lv = self.get_label_vector(lab)
            denom = np.linalg.norm(v) * np.linalg.norm(lv)
            sim = float(v @ lv / denom) if denom > 0 else -np.inf
            if sim > best_sim:
                best, best_sim = lab, sim
        return best

    def infer_vector(self, text: str, steps: int = 30,
                     learning_rate: float = 0.05) -> np.ndarray:
        """Gradient steps on a fresh doc vector, tables frozen (reference:
        ParagraphVectors.inferVector)."""
        toks = [
            self.vocab.word_for(t).index
            for t in self.tokenizer_factory.create(text).get_tokens()
            if self.vocab.contains_word(t)
        ]
        rng = np.random.default_rng(self.seed)
        v0 = ((rng.random(self.layer_size) - 0.5) / self.layer_size).astype(np.float32)
        if not toks:
            return v0
        dev = self.device
        tgt = np.asarray(toks, np.int32)
        v = torch.tensor(v0, device=dev)
        if self.use_hs:
            node = torch.tensor(self.lookup.syn1[self._points_arr[tgt]], device=dev)
            sign = 1.0 - 2.0 * torch.tensor(self._codes_arr[tgt], device=dev)
            cmask = torch.tensor(self._code_mask[tgt], device=dev)
            rows = node.reshape(-1, self.layer_size)  # [N * L, D]

            def grad(vec):
                u = (node @ vec)  # [N, L]
                return (-sign * torch.sigmoid(-sign * u) * cmask).reshape(1, -1) @ rows

        else:
            negs = self.lookup.sample_negatives(rng, (len(tgt), self.negative)).astype(np.int32)
            pos_rows = torch.tensor(self.lookup.syn1neg[tgt], device=dev)  # [N, D]
            neg_rows = torch.tensor(self.lookup.syn1neg[negs], device=dev)  # [N, K, D]

            def grad(vec):
                g_pos = -torch.sigmoid(-(pos_rows @ vec))
                g_neg = torch.sigmoid(neg_rows @ vec)
                return (g_pos[None] @ pos_rows
                        + g_neg.reshape(1, -1) @ neg_rows.reshape(-1, self.layer_size))

        for _ in range(steps):
            v = v - learning_rate * grad(v).reshape(-1)
        return v.cpu().numpy()
