"""Content-addressed text-encoder output cache, the local tier (counterpart of
``comfyui_parallelanything_tpu/models/embed_cache.py``).

Entries are keyed by (model key, tower, token ids, mask) through an md5 content
address: process- and node-id-independent. The model key is the loader's
content stamp (file identity and tower settings) when there is one, else a
lifetime token of the encoder object, which is never reused after the object
dies. The cache is an LRU bounded in bytes (``PA_EMBED_CACHE_BYTES``, default
256 MiB; 0 turns caching off). Lookups and inserts hold a lock; when two callers
race the same miss, the first insert wins and the loser's value goes back to its
caller uncached. A hit returns the cached tensors themselves, so cached and fresh
values are bitwise equal.

Left out until the fleet tier (ROADMAP Queue 1 item 9d): the remote tier (a fetch from
encode-pool hosts) and the metrics gauges and counters.
"""

from __future__ import annotations

import hashlib
import os
import threading
import uuid
from collections import OrderedDict

import numpy as np

DEFAULT_BYTES = 256 * 1024 * 1024


def cache_budget_bytes() -> int:
    """The byte bound from ``PA_EMBED_CACHE_BYTES`` (0 disables)."""
    try:
        return int(os.environ.get("PA_EMBED_CACHE_BYTES", DEFAULT_BYTES))
    except ValueError:
        return DEFAULT_BYTES


_token_lock = threading.Lock()


def lifetime_token(obj, attr: str = "_pa_embed_token") -> str:
    """A token unique to ``obj`` for its lifetime (unlike ``id()``, never reused),
    kept on the object. Made under a lock: concurrent prompt workers asking for the
    first time must get one token, or one object keys two cache entries (two
    decode groups)."""
    tok = getattr(obj, attr, None)
    if tok is None:
        with _token_lock:
            tok = getattr(obj, attr, None)
            if tok is None:
                tok = uuid.uuid4().hex
                object.__setattr__(obj, attr, tok)
    return tok


def encoder_token(enc) -> str:
    """The model-key fallback when no loader content stamp exists."""
    return lifetime_token(enc, "_pa_embed_token")


def file_stamp(path: str) -> tuple:
    """(path, size, mtime_ns): replacing a file in place changes the stamp. A
    missing path degrades to the bare path."""
    try:
        st = os.stat(path)
        return (path, st.st_size, st.st_mtime_ns)
    except OSError:
        return (path, None, None)


def _int32_bytes(a) -> bytes:
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(a, np.int32)).tobytes()


def stable_key(model_key: str, tower: str, ids, mask=None) -> str:
    """md5 content address over (model key, tower, token ids, mask). Keying on the
    token ids folds the tokenizer tables and ``max_len`` in."""
    h = hashlib.md5()
    h.update(str(model_key).encode())
    h.update(b"\x00" + str(tower).encode() + b"\x00")
    h.update(_int32_bytes(ids))
    h.update(b"\x00")
    if mask is not None:
        h.update(_int32_bytes(mask))
    return h.hexdigest()


def _value_bytes(value) -> int:
    """Bytes of a cached value: one tensor, or a tuple of tensors and Nones."""
    leaves = value if isinstance(value, (tuple, list)) else (value,)
    return sum(int(l.numel() * l.element_size()) if hasattr(l, "numel") else
               int(getattr(l, "nbytes", 0) or 0) for l in leaves if l is not None)


class EmbedCache:
    """Byte-bounded LRU of encoder outputs, with per-owner release so a torn-down
    encoder (a ``host.WorkflowCache`` eviction) frees its entries at once."""

    def __init__(self, max_bytes: int | None = None):
        self._max_bytes = max_bytes
        self._lock = threading.Lock()
        # key -> (value, nbytes, owner token), oldest first.
        self._entries: OrderedDict[str, tuple] = OrderedDict()  # guarded-by: _lock
        self._owners: dict[str, set[str]] = {}  # guarded-by: _lock
        self._bytes = 0  # guarded-by: _lock
        self._hits = 0  # guarded-by: _lock
        self._misses = 0  # guarded-by: _lock
        self._evictions = 0  # guarded-by: _lock

    def budget(self) -> int:
        return self._max_bytes if self._max_bytes is not None else cache_budget_bytes()

    def enabled(self) -> bool:
        return self.budget() > 0

    def get(self, key: str):
        """The cached value (moved to most recent) or None."""
        if not self.enabled():
            return None
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self._misses += 1
            else:
                self._entries.move_to_end(key)
                self._hits += 1
        return entry[0] if entry is not None else None

    def put(self, key: str, value, owner: str | None = None):
        """Insert; an incumbent wins and is returned (the caller's duplicate stays
        the caller's). Evicts the oldest entries until the bound holds; a value
        larger than the whole budget is returned uncached."""
        if not self.enabled():
            return value
        nbytes = _value_bytes(value)
        with self._lock:
            incumbent = self._entries.get(key)
            if incumbent is not None:
                self._entries.move_to_end(key)
                return incumbent[0]
            if nbytes > self.budget():
                return value
            self._entries[key] = (value, nbytes, owner)
            self._bytes += nbytes
            if owner is not None:
                self._owners.setdefault(owner, set()).add(key)
            while self._bytes > self.budget() and len(self._entries) > 1:
                self._evict_oldest()
        return value

    def _evict_oldest(self) -> None:  # holds _lock
        old_key, (_, old_bytes, old_owner) = self._entries.popitem(last=False)
        self._bytes -= old_bytes
        self._evictions += 1
        if old_owner is not None:
            keys = self._owners.get(old_owner)
            if keys is not None:
                keys.discard(old_key)
                if not keys:
                    self._owners.pop(old_owner, None)

    def release_owner(self, owner: str) -> int:
        """Drop every entry an owner token holds; returns how many dropped."""
        with self._lock:
            keys = self._owners.pop(owner, None)
            if not keys:
                return 0
            n = 0
            for key in keys:
                entry = self._entries.pop(key, None)
                if entry is not None:
                    self._bytes -= entry[1]
                    n += 1
        return n

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._owners.clear()
            self._bytes = 0

    def stats(self) -> dict:
        with self._lock:
            return {"enabled": self.enabled(), "entries": len(self._entries),
                    "bytes": self._bytes, "budget_bytes": self.budget(),
                    "hits": self._hits, "misses": self._misses,
                    "evictions": self._evictions}


# The process-wide cache every encode site consults. Tests may clear() it.
cache = EmbedCache()


def cached_encode(enc, model_key: str | None, tower: str, ids, mask, compute):
    """The one encode seam: look up (model key, tower, ids, mask); on a miss run
    ``compute()`` and bank its value. A hit returns the banked value and
    ``compute`` is not called. ``model_key`` None falls back to the encoder's
    lifetime token."""
    owner = encoder_token(enc)
    key = stable_key(model_key or owner, tower, ids, mask)
    hit = cache.get(key)
    if hit is not None:
        return hit
    return cache.put(key, compute(), owner=owner)


def release_wire(value) -> None:
    """Release the entries of every encoder inside a node-cache value (a CLIP wire
    dict, possibly nesting ``l``/``g``/``t5`` wires): ``host.WorkflowCache`` calls
    it when it evicts an entry."""
    if not isinstance(value, dict):
        return
    enc = value.get("encoder")
    if enc is not None:
        tok = getattr(enc, "_pa_embed_token", None)
        if tok is not None:
            cache.release_owner(tok)
    for sub in ("l", "g", "t5"):
        release_wire(value.get(sub))
