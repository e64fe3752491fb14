"""UI internationalization: key -> message catalogs per ISO 639-1 language
(a copy of ``deeplearning4j_tpu/ui/i18n.py``; the catalogs are the JAX
package's, word for word).

Reference: deeplearning4j-play's ``I18N``/``DefaultI18N``/``I18NProvider``
(deeplearning4j-ui-parent/deeplearning4j-play/src/main/java/org/
deeplearning4j/ui/api/I18N.java, .../i18n/DefaultI18N.java) — messages are
addressed by (language code, dotted key) with a default-language fallback,
loaded from ``dl4j_i18n`` properties resources, and exposed to the Play
templates plus a ``/setlang/:code`` route. This UI mirrors the
architecture: in-module catalogs (en/ja/ko/de/ru/zh), a properties-format
loader for user-supplied catalogs, a process-wide provider, and the server
renders ``@@key@@`` tokens through :meth:`I18N.get_message` with the same
language-then-default-then-key fallback chain.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, Optional

DEFAULT_LANGUAGE = "en"

# Catalogs for the UI chrome. Keys are dotted like the reference's
# (train.nav.*, train.overview.*, ...); unknown keys fall back default-lang
# then to the key itself so a missing translation never blanks the page.
_CATALOGS: Dict[str, Dict[str, str]] = {
    "en": {
        "train.pagetitle": "deeplearning4j_tpu Training UI",
        "train.nav.overview": "Overview",
        "train.nav.model": "Model",
        "train.nav.system": "System",
        "train.nav.flow": "Flow",
        "train.nav.activations": "Activations",
        "train.nav.tsne": "t-SNE",
        "train.nav.language": "Language",
        "train.overview.title": "Training overview",
        "train.overview.chart.score": "Score vs iteration",
        "train.overview.chart.itertime": "Iteration time (ms)",
        "train.overview.sessions": "Sessions",
        "train.overview.model": "Model",
        "train.model.title": "Model",
        "train.model.meanmag": "Mean magnitude vs iteration",
        "train.model.histogram": "Latest histogram",
        "train.model.allhist": "All layers — latest histograms",
        "train.system.title": "System",
        "train.system.memory": "Memory",
        "train.flow.title": "Flow",
        "train.activations.title": "Conv activations",
        "train.tsne.title": "t-SNE",
    },
    "ja": {
        "train.pagetitle": "deeplearning4j_tpu 学習UI",
        "train.nav.overview": "概要",
        "train.nav.model": "モデル",
        "train.nav.system": "システム",
        "train.nav.flow": "フロー",
        "train.nav.activations": "活性化",
        "train.nav.language": "言語",
        "train.overview.title": "学習の概要",
        "train.overview.chart.score": "スコア対反復",
        "train.overview.chart.itertime": "反復時間 (ms)",
        "train.overview.sessions": "セッション",
        "train.overview.model": "モデル",
        "train.model.title": "モデル",
        "train.model.meanmag": "平均絶対値対反復",
        "train.model.histogram": "最新ヒストグラム",
        "train.system.title": "システム",
        "train.system.memory": "メモリ",
    },
    "ko": {
        "train.pagetitle": "deeplearning4j_tpu 학습 UI",
        "train.nav.overview": "개요",
        "train.nav.model": "모델",
        "train.nav.system": "시스템",
        "train.nav.language": "언어",
        "train.overview.title": "학습 개요",
        "train.overview.sessions": "세션",
        "train.model.title": "모델",
        "train.system.title": "시스템",
    },
    "de": {
        "train.pagetitle": "deeplearning4j_tpu Training",
        "train.nav.overview": "Übersicht",
        "train.nav.model": "Modell",
        "train.nav.system": "System",
        "train.nav.language": "Sprache",
        "train.overview.title": "Trainingsübersicht",
        "train.overview.chart.score": "Score über Iterationen",
        "train.overview.sessions": "Sitzungen",
        "train.model.title": "Modell",
        "train.system.title": "System",
    },
    "ru": {
        "train.pagetitle": "deeplearning4j_tpu: интерфейс обучения",
        "train.nav.overview": "Общая информация",
        "train.nav.model": "Модель",
        "train.nav.system": "Система",
        "train.nav.language": "Язык",
        "train.overview.title": "Ход обучения",
        "train.overview.sessions": "Сессии",
        "train.model.title": "Модель",
        "train.system.title": "Система",
    },
    "zh": {
        "train.pagetitle": "deeplearning4j_tpu 训练界面",
        "train.nav.overview": "概述",
        "train.nav.model": "模型",
        "train.nav.system": "系统",
        "train.nav.language": "语言",
        "train.overview.title": "训练概述",
        "train.overview.sessions": "会话",
        "train.model.title": "模型",
        "train.system.title": "系统",
    },
}


class I18N:
    """Message lookup with (language, default-language, key) fallback.

    Thread-safe: the UI server resolves messages from request-handler
    threads while ``set_default_language`` may run on the main thread.
    """

    def __init__(self, default_language: str = DEFAULT_LANGUAGE):
        self._lock = threading.Lock()
        self._default = default_language
        self._messages: Dict[str, Dict[str, str]] = {
            lang: dict(cat) for lang, cat in _CATALOGS.items()
        }

    # -- reference I18N surface ---------------------------------------
    def get_message(self, key: str, lang: Optional[str] = None) -> str:
        """Message for ``key`` in ``lang`` (default language when None).

        Falls back language -> default language -> the key itself (the
        reference returns null; the UI variant returns the key so a page
        never renders an empty heading).
        """
        with self._lock:
            for code in (lang, self._default, DEFAULT_LANGUAGE):
                if code and key in self._messages.get(code, ()):
                    return self._messages[code][key]
        return key

    def get_default_language(self) -> str:
        with self._lock:
            return self._default

    def set_default_language(self, lang_code: str) -> None:
        with self._lock:
            self._default = lang_code

    # -- catalog management -------------------------------------------
    def languages(self) -> Iterable[str]:
        with self._lock:
            return sorted(self._messages)

    def catalog(self, lang: Optional[str] = None) -> Dict[str, str]:
        """Merged default+lang catalog (what ``/api/i18n`` serves)."""
        with self._lock:
            merged = dict(self._messages.get(DEFAULT_LANGUAGE, {}))
            merged.update(self._messages.get(self._default, {}))
            if lang:
                merged.update(self._messages.get(lang, {}))
            return merged

    def add_messages(self, lang_code: str, messages: Dict[str, str]) -> None:
        with self._lock:
            self._messages.setdefault(lang_code, {}).update(messages)

    def load_properties(self, path: str, lang_code: str) -> int:
        """Load a ``key=value`` properties file (the reference's dl4j_i18n
        resource format) into ``lang_code``; returns entries added."""
        entries: Dict[str, str] = {}
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith(("#", "!")) or "=" not in line:
                    continue
                k, v = line.split("=", 1)
                entries[k.strip()] = v.strip()
        self.add_messages(lang_code, entries)
        return len(entries)

    # -- rendering ----------------------------------------------------
    def render(self, template: str, lang: Optional[str] = None) -> str:
        """Substitute every ``@@dotted.key@@`` token via get_message."""
        out = []
        rest = template
        while True:
            head, sep, tail = rest.partition("@@")
            out.append(head)
            if not sep:
                return "".join(out)
            key, sep2, rest = tail.partition("@@")
            if not sep2:  # unbalanced token: emit literally
                out.append("@@" + key)
                return "".join(out)
            out.append(self.get_message(key, lang))


_instance: Optional[I18N] = None
_instance_lock = threading.Lock()


def get_instance() -> I18N:
    """Process-wide provider (reference: I18NProvider.getInstance)."""
    global _instance
    with _instance_lock:
        if _instance is None:
            _instance = I18N()
        return _instance
