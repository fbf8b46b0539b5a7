"""Persistent tuner cache: a JSON file of ``tuning`` dicts for
:func:`tensorfft_tpu_torch.plan.create_plan`.

The port's copy of ``tensorfft_tpu/tuning/cache.py`` with the same key format
(``n=<length>,precision=<policy>,platform=<platform>[,batch=<B>]``), file
format (version 1), promotion rule and merge-on-save, so one file can serve
both packages: the platform in the key keeps their entries apart (``cuda``
for the card, ``cpu`` for the plain versions).  ``TENSORFFT_TUNER_CACHE``
names the file; by default it is ``tuning/tuner_cache.json`` beside this
module, and a missing file is an empty cache.

Two differences from the JAX package's writer:

* ``save`` holds an exclusive ``fcntl.flock`` on a sidecar lock file
  (``<file>.lock``) across its read-merge-write, and writes through a temp
  file of its own in the same directory before ``os.replace``, so concurrent
  writers neither interleave nor share one temp path;
* an exact-batch key is guarded as the blind key is: a new entry replaces
  the incumbent only when the incumbent is non-finite or is not faster.
"""
from __future__ import annotations

import fcntl
import json
import math
import os
import tempfile
from pathlib import Path
from typing import Optional

__all__ = ["TunerCache", "default_cache_path"]

_VERSION = 1


def _finite(entry: Optional[dict]) -> bool:
    """An entry is servable only if its measurement metadata is finite."""
    if entry is None:
        return False
    t = entry.get("time_us")
    return t is None or (isinstance(t, (int, float)) and math.isfinite(t))


def _not_slower(entry: dict, incumbent: Optional[dict]) -> bool:
    """Whether ``entry`` may replace ``incumbent`` under the same key: the
    incumbent is missing or non-finite, or ``entry`` is not slower."""
    return not _finite(incumbent) or (
        float(entry.get("time_us", math.inf))
        <= float(incumbent.get("time_us", math.inf)))


def _incumbent(entries: dict, key: str) -> Optional[dict]:
    """The entry ``key`` stands for: an exact-batch key whose twin dedupe()
    dropped stands for the blind entry tuned at that batch."""
    entry = entries.get(key)
    if entry is None and ",batch=" in key:
        base, batch = key.rsplit(",batch=", 1)
        blind = entries.get(base)
        if blind is not None and str(blind.get("batch")) == batch:
            entry = blind
    return entry


# Tuner cache files this process has written (``TunerCache.save``): plans
# kept by the N-D dispatch (``fft._nd_plan``) are keyed on it.
writes = 0


def default_cache_path() -> Path:
    env = os.environ.get("TENSORFFT_TUNER_CACHE")
    if env:
        return Path(env)
    return Path(__file__).parent / "tuner_cache.json"


def _key(
    fft_length: int, precision: str, platform: str, batch: Optional[int] = None
) -> str:
    base = f"n={fft_length},precision={precision},platform={platform}"
    return base if batch is None else f"{base},batch={batch}"


def _promote_over(entry: dict, blind: Optional[dict]) -> bool:
    """Should a batch-keyed ``entry`` replace the batch-blind ``blind``?

    Promote when tuned at a larger batch (the blind entry stands for the
    production scale), or at an equal batch when not slower.  A missing or
    non-finite blind is always replaced.
    """
    if not _finite(blind):
        return True
    blind_batch = int(blind.get("batch", 0))
    batch = int(entry.get("batch", 0))
    return blind_batch < batch or (blind_batch == batch
                                   and _not_slower(entry, blind))


def _read_entries(path: Path) -> dict:
    data = json.loads(path.read_text())
    return data.get("entries", {}) if data.get("version") == _VERSION else {}


class TunerCache:
    def __init__(self, path: Optional[os.PathLike] = None):
        self.path = Path(path) if path is not None else default_cache_path()
        self._entries: dict = {}
        # Keys this process wrote through put(); save() persists only these,
        # merged over a fresh read of the file.
        self._dirty: set = set()
        if self.path.exists():
            self._entries = _read_entries(self.path)

    def get(
        self,
        fft_length: int,
        precision: str,
        platform: str,
        batch: Optional[int] = None,
    ) -> Optional[dict]:
        """Tuning dict for ``create_plan(tuning=...)``, or None if untuned.

        With ``batch``, an entry tuned at that exact batch takes priority;
        the batch-blind entry is the fallback either way.
        """
        entry = None
        if batch is not None:
            entry = self._entries.get(_key(fft_length, precision, platform, batch))
            if not _finite(entry):
                entry = None
        if entry is None:
            entry = self._entries.get(_key(fft_length, precision, platform))
            if not _finite(entry):
                entry = None
        if entry is None:
            return None
        tuning = dict(entry)
        for meta in ("time_us", "gflops", "batch"):
            tuning.pop(meta, None)
        if "radices" in tuning:
            tuning["radices"] = tuple(tuning["radices"])
        if tuning.get("four_step_split") is not None:
            tuning["four_step_split"] = tuple(tuning["four_step_split"])
        else:
            tuning.pop("four_step_split", None)
        return tuning

    def put(
        self,
        fft_length: int,
        precision: str,
        platform: str,
        entry: dict,
        batch: Optional[int] = None,
    ):
        """Record a winner.

        With ``batch``, the entry goes under the exact-batch key when it is
        not slower than the incumbent there, and is promoted to the
        batch-blind key by :func:`_promote_over`.  Non-finite measurements
        are refused.
        """
        if not _finite(entry):
            raise ValueError(
                f"refusing to cache a non-finite tuner winner for "
                f"n={fft_length}, precision={precision}: {entry!r}"
            )
        blind_key = _key(fft_length, precision, platform)
        if batch is None:
            self._set(blind_key, entry)
            return
        entry = dict(entry, batch=int(batch))
        k = _key(fft_length, precision, platform, batch)
        if _not_slower(entry, _incumbent(self._entries, k)):
            self._set(k, entry)
        if _promote_over(entry, self._entries.get(blind_key)):
            self._set(blind_key, entry)

    def _set(self, key: str, entry: dict) -> None:
        self._entries[key] = entry
        self._dirty.add(key)

    def dedupe(self) -> int:
        """Drop batch-suffixed entries identical to their blind twin (get()
        falls back to the blind key); returns the number removed."""
        drop = [
            k for k, v in self._entries.items()
            if ",batch=" in k
            and self._entries.get(k.rsplit(",batch=", 1)[0]) == v
        ]
        for k in drop:
            del self._entries[k]
        return len(drop)

    def save(self):
        """Persist this process's winners over a fresh read of the file.

        A dirty exact-batch key and a dirty batch-suffixed blind key are
        re-tested against what is on disk now (a concurrent writer's faster
        or larger-batch winner survives); a blind entry put without a batch
        is a deliberate choice and overwrites.
        """
        self.path.parent.mkdir(parents=True, exist_ok=True)
        lock_path = self.path.with_name(self.path.name + ".lock")
        with open(lock_path, "a") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                self._merge_and_write()
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)

    def _merge_and_write(self) -> None:
        if self.path.exists():
            try:
                disk = _read_entries(self.path)
            except (OSError, ValueError):
                disk = {}
            merged = dict(disk)
            for k in self._dirty:
                mine = self._entries.get(k)
                if mine is None:
                    continue
                if ",batch=" in k:
                    keep = _not_slower(mine, _incumbent(disk, k))
                else:
                    keep = "batch" not in mine or _promote_over(mine, disk.get(k))
                if keep:
                    merged[k] = mine
            self._entries = merged
        self.dedupe()
        # allow_nan=False: bare Infinity/NaN is not JSON; fail before writing.
        text = json.dumps({"version": _VERSION, "entries": self._entries},
                          indent=1, sort_keys=True, allow_nan=False)
        fd, tmp = tempfile.mkstemp(prefix=self.path.name + ".",
                                   suffix=".tmp", dir=self.path.parent)
        try:
            with os.fdopen(fd, "w") as f:
                f.write(text)
            os.replace(tmp, self.path)
        except BaseException:
            os.unlink(tmp)
            raise
        global writes
        writes += 1

    def __len__(self):
        return len(self._entries)
