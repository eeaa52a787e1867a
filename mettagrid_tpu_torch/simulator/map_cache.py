"""Cross-process prebuilt-map cache (reference: simulator/map_cache.py:32-124).

A file registry under a shared directory: maps are built once per
(builder-config fingerprint, seed) and reloaded as .npy grids by other
processes. Locking via atomic O_EXCL lock files."""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Callable, Optional

import numpy as np

from mettagrid_tpu_torch.maps.map_builder import GameMap


class SharedMapCache:
    def __init__(self, cache_dir: str, max_entries: int = 1024):
        self._dir = cache_dir
        os.makedirs(cache_dir, exist_ok=True)
        self._max_entries = max_entries

    def _key(self, builder_config, seed: int) -> str:
        payload = json.dumps(
            [builder_config.model_dump(mode="json"), seed], sort_keys=True, default=str
        )
        return hashlib.sha256(payload.encode()).hexdigest()[:24]

    def _path(self, key: str) -> str:
        return os.path.join(self._dir, f"{key}.npy")

    def get_or_create(
        self, builder_config, seed: int, build: Optional[Callable[[], GameMap]] = None
    ) -> GameMap:
        key = self._key(builder_config, seed)
        path = self._path(key)
        if os.path.exists(path):
            return GameMap(np.load(path, allow_pickle=False))

        lock = path + ".lock"
        try:
            fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            os.close(fd)
        except FileExistsError:
            # Another process is building; wait for the artifact.
            for _ in range(600):
                if os.path.exists(path):
                    return GameMap(np.load(path, allow_pickle=False))
                time.sleep(0.05)
            raise TimeoutError(f"map cache entry {key} never appeared")

        try:
            if build is None:
                cfg = builder_config
                if hasattr(cfg, "seed"):
                    cfg = cfg.model_copy(update={"seed": seed})
                gm = cfg.create().build()
            else:
                gm = build()
            tmp = path + ".tmp"
            np.save(tmp, gm.grid, allow_pickle=False)
            os.replace(tmp + ".npy" if os.path.exists(tmp + ".npy") else tmp, path)
            self._evict()
            return gm
        finally:
            os.unlink(lock)

    def _evict(self) -> None:
        entries = sorted(
            (os.path.getmtime(os.path.join(self._dir, f)), f)
            for f in os.listdir(self._dir)
            if f.endswith(".npy")
        )
        while len(entries) > self._max_entries:
            _, f = entries.pop(0)
            try:
                os.unlink(os.path.join(self._dir, f))
            except OSError:
                pass
