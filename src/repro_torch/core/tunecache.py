"""Persistent schedule cache: the paper's JIT plan cache, across processes.

A copy of ``repro/core/tunecache.py`` with the port's own location, so that
the two packages never read each other's entries.  It stores tuning
outcomes (ranked spec strings, blocking factors, scores, and measured times
where a ``measure_fn`` ran) on disk, keyed on everything that determines
the search result:

    (loop signature, tensor maps, dtype, flops/tiles, target, epilogue,
     search parameters, cache schema version)

``autotune`` / ``autotune_graph`` consult the cache before generating a
single candidate; a hit rebuilds the ranked ``TuneResult`` list from the
stored specs.  Entries carrying ``measured_s`` (times measured on the card)
keep their measured order on hits.

Location: ``$REPRO_TORCH_TUNE_CACHE_DIR`` if set, else ``build/tune-cache/``
in the checkout (beside the built kernels, ignored by git).  Disable with
``REPRO_TORCH_TUNE_CACHE=0`` (or ``off``/``no``/``false``).  Each entry is
one ``<sha256>.json`` file; ``TuneCache().clear()`` or removing the
directory resets it.  Counters ``tune.cache.hits``, ``.misses``,
``.corrupt_recoveries`` and ``.store_failures`` go to the port's default
registry (``repro_torch.obs.metrics``).
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
import time
import warnings
from pathlib import Path
from typing import Optional

from repro_torch.obs.metrics import default_registry

__all__ = [
    "CACHE_VERSION", "TuneCache", "default_cache_dir", "default_cache",
    "cache_key",
]

CACHE_VERSION = 1

_DISABLE_VALUES = ("0", "off", "no", "false")
_CHECKOUT = Path(__file__).resolve().parents[3]


def default_cache_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_TUNE_CACHE_DIR")
    if env:
        return Path(env).expanduser()
    return _CHECKOUT / "build" / "tune-cache"


def cache_key(**components) -> str:
    """sha256 over a canonical JSON rendering of the key components.  Values
    must be JSON-serializable after a str() fallback (dtypes, targets)."""
    blob = json.dumps(
        {"version": CACHE_VERSION, **components},
        sort_keys=True, default=str, separators=(",", ":"),
    )
    return hashlib.sha256(blob.encode()).hexdigest()


class TuneCache:
    """One directory of ``<key>.json`` tuning entries with atomic writes.

    Lookups tolerate missing/corrupt files (treated as misses) so concurrent
    writers and interrupted runs can never poison later searches.
    """

    def __init__(self, path=None):
        self.path = Path(path) if path is not None else default_cache_dir()

    def _file(self, key: str) -> Path:
        return self.path / f"{key}.json"

    def lookup(self, key: str) -> Optional[dict]:
        reg = default_registry()
        path = self._file(key)
        try:
            with open(path) as f:
                entry = json.load(f)
        except OSError:
            reg.counter("tune.cache.misses").inc()
            return None                       # no entry — a plain miss
        except ValueError:
            # corrupted/truncated file (interrupted writer, disk fault):
            # discard it with a warning so it cannot poison — or crash —
            # any later search, and fall through to a fresh tune
            warnings.warn(
                f"repro-torch-tune: discarding corrupted cache entry {path} "
                "(unreadable JSON); it will be re-tuned", RuntimeWarning)
            try:
                os.unlink(path)
            except OSError:
                pass
            reg.counter("tune.cache.corrupt_recoveries").inc()
            reg.counter("tune.cache.misses").inc()
            return None
        if not isinstance(entry, dict) or entry.get("version") != CACHE_VERSION:
            reg.counter("tune.cache.misses").inc()
            return None
        reg.counter("tune.cache.hits").inc()
        return entry

    def store(self, key: str, entry: dict) -> None:
        """Atomic write (temp file + ``os.replace``) so readers never see a
        half-written entry.  I/O failures warn instead of raising — a cache
        that cannot persist must not abort the autotune that produced the
        result."""
        entry = {"version": CACHE_VERSION, "stored_at": time.time(), **entry}
        try:
            self.path.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=self.path, suffix=".tmp")
        except OSError as exc:
            default_registry().counter("tune.cache.store_failures").inc()
            warnings.warn(f"repro-torch-tune: cannot write cache entry under "
                          f"{self.path} ({exc}); result not persisted",
                          RuntimeWarning)
            return
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(entry, f, indent=1)
            os.replace(tmp, self._file(key))
        except BaseException as exc:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            if isinstance(exc, OSError):
                default_registry().counter(
                    "tune.cache.store_failures").inc()
                warnings.warn(f"repro-torch-tune: failed writing cache entry "
                              f"{key[:12]}… ({exc}); result not persisted",
                              RuntimeWarning)
                return
            raise                 # e.g. TypeError: unserializable entry — a bug

    def clear(self) -> int:
        """Remove every entry; returns the number of files deleted."""
        n = 0
        if self.path.is_dir():
            for p in self.path.glob("*.json"):
                try:
                    p.unlink()
                    n += 1
                except OSError:
                    pass
        return n

    def __len__(self) -> int:
        return len(list(self.path.glob("*.json"))) if self.path.is_dir() else 0


def default_cache() -> Optional[TuneCache]:
    """The process-default cache, or ``None`` when disabled via env."""
    if os.environ.get("REPRO_TORCH_TUNE_CACHE", "").strip().lower() in _DISABLE_VALUES:
        return None
    return TuneCache()
