"""NLP stack (counterpart of ``deeplearning4j_tpu/nlp``; reference:
deeplearning4j-nlp-parent — SURVEY.md §2.5): SequenceVectors engine,
Word2Vec/ParagraphVectors/GloVe, tokenizer + sentence-iterator SPIs,
vocab/Huffman, word-vector serialization, text vectorizers and the
word-vector DataSet iterators, the CJK tokenizer plugins (Japanese and
Korean lattice segmenters) and the UIMA-style sentence and POS analyzers
(host only). Training runs on the card unless a model is
given ``device="cpu"``."""

from .tokenization import (
    Tokenizer,
    TokenizerFactory,
    DefaultTokenizerFactory,
    NGramTokenizerFactory,
    TokenPreProcess,
    CommonPreprocessor,
    EndingPreProcessor,
)
from .sentence_iterator import (
    SentenceIterator,
    CollectionSentenceIterator,
    BasicLineIterator,
    SentencePreProcessor,
    LabelledDocument,
    LabelAwareIterator,
    CollectionLabelAwareIterator,
)
from .vocab import VocabWord, VocabCache, VocabConstructor, Huffman
from .lookup import InMemoryLookupTable
from .sequence_vectors import Sequence, SequenceVectors
from .word2vec import Word2Vec
from .paragraph_vectors import ParagraphVectors
from .glove import Glove, AbstractCoOccurrences
from .stemming import PorterStemmer, StemmingPreprocessor
from .stopwords import STOP_WORDS
from .distributed import DistributedWord2Vec
from .tokenization_plugins import JapaneseTokenizerFactory, KoreanTokenizerFactory
from .uima_analyzers import (PosUimaTokenizerFactory, UimaSentenceIterator,
                             UimaTokenizerFactory, pos_tag, segment_sentences)
from .vectorizers import (
    BagOfWordsVectorizer,
    InvertedIndex,
    TfidfVectorizer,
    windows,
)
from .model_iterators import CnnSentenceDataSetIterator, Word2VecDataSetIterator
from .serialization import (
    write_word_vectors,
    load_txt_vectors,
    write_binary_model,
    read_binary_model,
    write_sequence_vectors,
    read_sequence_vectors,
)

__all__ = [
    "STOP_WORDS", "PorterStemmer", "StemmingPreprocessor", "DistributedWord2Vec",
    "JapaneseTokenizerFactory", "KoreanTokenizerFactory",
    "PosUimaTokenizerFactory", "UimaSentenceIterator", "UimaTokenizerFactory",
    "pos_tag", "segment_sentences",
    "BagOfWordsVectorizer", "TfidfVectorizer", "InvertedIndex", "windows",
    "CnnSentenceDataSetIterator", "Word2VecDataSetIterator",
    "Tokenizer", "TokenizerFactory", "DefaultTokenizerFactory",
    "NGramTokenizerFactory", "TokenPreProcess", "CommonPreprocessor",
    "EndingPreProcessor",
    "SentenceIterator", "CollectionSentenceIterator", "BasicLineIterator",
    "SentencePreProcessor", "LabelledDocument", "LabelAwareIterator",
    "CollectionLabelAwareIterator",
    "VocabWord", "VocabCache", "VocabConstructor", "Huffman",
    "InMemoryLookupTable",
    "Sequence", "SequenceVectors",
    "Word2Vec", "ParagraphVectors", "Glove", "AbstractCoOccurrences",
    "write_word_vectors", "load_txt_vectors", "write_binary_model",
    "read_binary_model", "write_sequence_vectors", "read_sequence_vectors",
]
