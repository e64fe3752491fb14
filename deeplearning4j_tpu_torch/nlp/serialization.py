"""Word-vector serialization: word2vec C formats + native zip (counterpart
of ``deeplearning4j_tpu/nlp/serialization.py``: the same bytes, so each
package reads the other's files).

Reference: models/embeddings/loader/WordVectorSerializer.java (2,739 LoC) —
writeWordVectors/loadTxtVectors (C text format: header "V D", one
word + floats per line), readBinaryModel (GoogleNews C binary format), and the
zipped DL4J format. All three supported here; the zip variant stores
vocab JSON + npz tables so training can resume exactly.
"""

from __future__ import annotations

import io
import json
import zipfile

import numpy as np

from .lookup import InMemoryLookupTable
from .vocab import VocabCache, VocabWord


def write_word_vectors(lookup: InMemoryLookupTable, path: str) -> None:
    """C text format (reference: WordVectorSerializer.writeWordVectors)."""
    with open(path, "w", encoding="utf-8") as f:
        f.write(f"{lookup.vocab.num_words()} {lookup.vector_length}\n")
        for vw in lookup.vocab.vocab_words():
            vec = " ".join(f"{x:.6f}" for x in lookup.syn0[vw.index])
            f.write(f"{vw.word} {vec}\n")


def load_txt_vectors(path: str) -> InMemoryLookupTable:
    """Reference: WordVectorSerializer.loadTxtVectors."""
    with open(path, encoding="utf-8") as f:
        header = f.readline().split()
        n, d = int(header[0]), int(header[1])
        cache = VocabCache()
        vecs = np.zeros((n, d), np.float32)
        for i in range(n):
            parts = f.readline().rstrip("\n").split(" ")
            cache.add_token(VocabWord(word=parts[0], count=1))
            vecs[i] = np.array(parts[1 : d + 1], np.float32)
    table = InMemoryLookupTable(cache, d, use_hs=False, negative=1)
    table.syn0 = vecs
    return table


def write_binary_model(lookup: InMemoryLookupTable, path: str) -> None:
    """GoogleNews-style C binary format (reference: readBinaryModel's inverse)."""
    with open(path, "wb") as f:
        f.write(f"{lookup.vocab.num_words()} {lookup.vector_length}\n".encode())
        for vw in lookup.vocab.vocab_words():
            f.write(vw.word.encode("utf-8") + b" ")
            f.write(lookup.syn0[vw.index].astype("<f4").tobytes())
            f.write(b"\n")


def read_binary_model(path: str) -> InMemoryLookupTable:
    """Reference: WordVectorSerializer.readBinaryModel (GoogleNews loader)."""
    with open(path, "rb") as f:
        header = f.readline().split()
        n, d = int(header[0]), int(header[1])
        cache = VocabCache()
        vecs = np.zeros((n, d), np.float32)
        for i in range(n):
            word = bytearray()
            while True:
                c = f.read(1)
                if c in (b" ", b""):
                    break
                word.extend(c)
            vecs[i] = np.frombuffer(f.read(4 * d), dtype="<f4")
            nl = f.read(1)  # trailing newline
            if nl not in (b"\n", b""):
                f.seek(-1, io.SEEK_CUR)
            cache.add_token(VocabWord(word=word.decode("utf-8"), count=1))
    table = InMemoryLookupTable(cache, d, use_hs=False, negative=1)
    table.syn0 = vecs
    return table


def write_sequence_vectors(model, path: str) -> None:
    """Zip format with full training state (reference: the DL4J zip format
    writeWord2VecModel — resumable)."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        vocab = [
            {
                "word": vw.word, "count": vw.count, "index": vw.index,
                "codes": vw.codes, "points": vw.points, "is_label": vw.is_label,
            }
            for vw in model.vocab.vocab_words()
        ]
        config = {
            "layer_size": model.layer_size,
            "window": model.window,
            "negative": model.negative,
            "use_hs": model.use_hs,
            "class": type(model).__name__,
        }
        z.writestr("config.json", json.dumps(config))
        z.writestr("vocab.json", json.dumps(vocab))
        buf = io.BytesIO()
        arrays = {"syn0": model.lookup.syn0}
        if model.lookup.syn1 is not None:
            arrays["syn1"] = model.lookup.syn1
        if model.lookup.syn1neg is not None:
            arrays["syn1neg"] = model.lookup.syn1neg
        np.savez(buf, **arrays)
        z.writestr("tables.npz", buf.getvalue())


def read_sequence_vectors(path: str, device="cuda"):
    """Restore a SequenceVectors model from the zip format, to train on
    ``device``."""
    from .sequence_vectors import SequenceVectors

    with zipfile.ZipFile(path) as z:
        config = json.loads(z.read("config.json"))
        vocab_list = json.loads(z.read("vocab.json"))
        tables = np.load(io.BytesIO(z.read("tables.npz")))
        cache = VocabCache()
        for item in sorted(vocab_list, key=lambda v: v["index"]):
            vw = VocabWord(word=item["word"], count=item["count"])
            vw.codes = item["codes"]
            vw.points = item["points"]
            vw.is_label = item["is_label"]
            cache.add_token(vw)
        model = SequenceVectors(
            layer_size=config["layer_size"], window=config["window"],
            negative=config["negative"], use_hs=config["use_hs"], device=device,
        )
        model.vocab = cache
        model.lookup = InMemoryLookupTable(
            cache, config["layer_size"], negative=config["negative"],
            use_hs=config["use_hs"],
        )
        model.lookup.syn0 = tables["syn0"]
        if "syn1" in tables:
            model.lookup.syn1 = tables["syn1"]
        if "syn1neg" in tables:
            model.lookup.syn1neg = tables["syn1neg"]
        if config["use_hs"]:
            model._pack_codes()  # the packed code arrays, for continued training
        return model
