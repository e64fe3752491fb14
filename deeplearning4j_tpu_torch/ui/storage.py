"""StatsStorage: UI-agnostic persistence for training stats (a copy of
``deeplearning4j_tpu/ui/storage.py``: a file or database that one package
writes reads back identically in the other).

Reference: deeplearning4j-core api/storage/StatsStorage.java +
StatsStorageRouter.java, with backends mirroring the reference's in-memory /
MapDB / SQLite trio (ui/storage/InMemoryStatsStorage, mapdb/MapDBStatsStorage,
sqlite/) — here: in-memory dict, JSON-lines file, and stdlib sqlite3.

Records are JSON dicts keyed (session_id, type_id, worker_id, timestamp) like
the reference's Persistable flyweights (Agrona encoding replaced by JSON —
the wire format is not the bottleneck off the device).
"""

from __future__ import annotations

import json
import os
import sqlite3
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple


class StatsStorageRouter:
    """Write-side API (reference: StatsStorageRouter.java)."""

    def put_static_info(self, record: dict) -> None:
        raise NotImplementedError

    def put_update(self, record: dict) -> None:
        raise NotImplementedError


class StatsStorage(StatsStorageRouter):
    """Read+write+listen (reference: StatsStorage.java)."""

    def __init__(self):
        self._listeners: List[Callable[[dict], None]] = []

    # -- listeners (UI subscribes; reference: StatsStorageListener) --
    def register_listener(self, fn: Callable[[dict], None]) -> None:
        self._listeners.append(fn)

    def _notify(self, event: dict) -> None:
        for fn in list(self._listeners):
            fn(event)

    # -- read API --
    def list_session_ids(self) -> List[str]:
        raise NotImplementedError

    def list_worker_ids(self, session_id: str) -> List[str]:
        raise NotImplementedError

    def list_update_worker_ids(self, session_id: str) -> List[str]:
        """Workers with UPDATE records (excludes static-only pseudo-workers);
        default derives from get_all_updates — backends override with an
        index scan."""
        return sorted({r.get("worker_id", "0")
                       for r in self.get_all_updates(session_id)})

    def get_static_info(self, session_id: str, worker_id: Optional[str] = None) -> List[dict]:
        raise NotImplementedError

    def get_all_updates(self, session_id: str, worker_id: Optional[str] = None) -> List[dict]:
        raise NotImplementedError

    def get_latest_update(self, session_id: str, worker_id: Optional[str] = None) -> Optional[dict]:
        ups = self.get_all_updates(session_id, worker_id)
        return ups[-1] if ups else None

    def get_updates_after(self, session_id: str, timestamp: float,
                          worker_id: Optional[str] = None) -> List[dict]:
        return [u for u in self.get_all_updates(session_id, worker_id)
                if u["timestamp"] > timestamp]

    def close(self) -> None:
        pass


def _key(record: dict) -> Tuple[str, str]:
    return (record.get("session_id", "default"), record.get("worker_id", "0"))


class InMemoryStatsStorage(StatsStorage):
    """Reference: ui/storage/InMemoryStatsStorage.java."""

    def __init__(self):
        super().__init__()
        self._static: Dict[Tuple[str, str], List[dict]] = {}
        self._updates: Dict[Tuple[str, str], List[dict]] = {}
        self._lock = threading.Lock()

    def put_static_info(self, record: dict) -> None:
        with self._lock:
            self._static.setdefault(_key(record), []).append(record)
        self._notify({"type": "static", "record": record})

    def put_update(self, record: dict) -> None:
        with self._lock:
            self._updates.setdefault(_key(record), []).append(record)
        self._notify({"type": "update", "record": record})

    def list_session_ids(self) -> List[str]:
        with self._lock:
            return sorted({s for s, _ in list(self._static) + list(self._updates)})

    def list_worker_ids(self, session_id: str) -> List[str]:
        with self._lock:
            return sorted(
                {w for s, w in list(self._static) + list(self._updates) if s == session_id}
            )

    def list_update_worker_ids(self, session_id: str) -> List[str]:
        # O(#workers) key scan — no record materialization
        with self._lock:
            return sorted({w for s, w in self._updates if s == session_id})

    def _collect(self, store, session_id, worker_id):
        with self._lock:
            out = []
            for (s, w), recs in store.items():
                if s == session_id and (worker_id is None or w == worker_id):
                    out.extend(recs)
            return sorted(out, key=lambda r: r.get("timestamp", 0))

    def get_static_info(self, session_id, worker_id=None):
        return self._collect(self._static, session_id, worker_id)

    def get_all_updates(self, session_id, worker_id=None):
        return self._collect(self._updates, session_id, worker_id)


class FileStatsStorage(InMemoryStatsStorage):
    """JSON-lines append-only file backend (reference: FileStatsStorage.java /
    MapDBStatsStorage.java role — durable single-file storage). Reloads
    existing records on open."""

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    rec = json.loads(line)
                    kind = rec.pop("_kind", "update")
                    if kind == "static":
                        InMemoryStatsStorage.put_static_info(self, rec)
                    else:
                        InMemoryStatsStorage.put_update(self, rec)
        self._f = open(path, "a")

    def _append(self, kind: str, record: dict) -> None:
        self._f.write(json.dumps({**record, "_kind": kind}) + "\n")
        self._f.flush()

    def put_static_info(self, record: dict) -> None:
        super().put_static_info(record)
        self._append("static", record)

    def put_update(self, record: dict) -> None:
        super().put_update(record)
        self._append("update", record)

    def close(self) -> None:
        self._f.close()


class SqliteStatsStorage(StatsStorage):
    """SQLite backend (reference: ui/storage/sqlite/). Thread-safe via one
    connection per call; records stored as JSON blobs with indexed keys."""

    _SCHEMA = """
    CREATE TABLE IF NOT EXISTS records (
        kind TEXT NOT NULL, session_id TEXT NOT NULL, worker_id TEXT NOT NULL,
        timestamp REAL NOT NULL, payload TEXT NOT NULL
    );
    CREATE INDEX IF NOT EXISTS idx_records ON records(session_id, worker_id, timestamp);
    """

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        with self._conn() as c:
            c.executescript(self._SCHEMA)

    def _conn(self):
        return sqlite3.connect(self.path)

    def _put(self, kind: str, record: dict) -> None:
        with self._conn() as c:
            c.execute(
                "INSERT INTO records VALUES (?,?,?,?,?)",
                (
                    kind,
                    record.get("session_id", "default"),
                    record.get("worker_id", "0"),
                    record.get("timestamp", time.time()),
                    json.dumps(record),
                ),
            )
        self._notify({"type": kind, "record": record})

    def put_static_info(self, record: dict) -> None:
        self._put("static", record)

    def put_update(self, record: dict) -> None:
        self._put("update", record)

    def list_session_ids(self) -> List[str]:
        with self._conn() as c:
            return [r[0] for r in c.execute("SELECT DISTINCT session_id FROM records ORDER BY 1")]

    def list_worker_ids(self, session_id: str) -> List[str]:
        with self._conn() as c:
            return [
                r[0]
                for r in c.execute(
                    "SELECT DISTINCT worker_id FROM records WHERE session_id=? ORDER BY 1",
                    (session_id,),
                )
            ]

    def _get(self, kind, session_id, worker_id):
        q = "SELECT payload FROM records WHERE kind=? AND session_id=?"
        args = [kind, session_id]
        if worker_id is not None:
            q += " AND worker_id=?"
            args.append(worker_id)
        q += " ORDER BY timestamp"
        with self._conn() as c:
            return [json.loads(r[0]) for r in c.execute(q, args)]

    def get_static_info(self, session_id, worker_id=None):
        return self._get("static", session_id, worker_id)

    def get_all_updates(self, session_id, worker_id=None):
        return self._get("update", session_id, worker_id)

    def list_update_worker_ids(self, session_id: str) -> List[str]:
        with self._conn() as c:
            return [r[0] for r in c.execute(
                "SELECT DISTINCT worker_id FROM records "
                "WHERE kind='update' AND session_id=? ORDER BY 1",
                (session_id,))]


class RemoteStatsStorageRouter(StatsStorageRouter):
    """POST records to a remote UI server (reference:
    deeplearning4j-ui-remote-iterationlisteners WebReporter.java + the Play
    remote-stats receiver module). Used by distributed workers to report to a
    central dashboard."""

    def __init__(self, url: str, timeout: float = 5.0):
        self.url = url.rstrip("/")
        self.timeout = timeout

    def _post(self, endpoint: str, record: dict) -> None:
        import urllib.request

        req = urllib.request.Request(
            f"{self.url}{endpoint}",
            data=json.dumps(record).encode(),
            headers={"Content-Type": "application/json"},
        )
        urllib.request.urlopen(req, timeout=self.timeout).read()

    def put_static_info(self, record: dict) -> None:
        self._post("/remote/static", record)

    def put_update(self, record: dict) -> None:
        self._post("/remote/update", record)
