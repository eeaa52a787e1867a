"""Bit-exact reference RNG: std::mt19937 + libstdc++ shuffle semantics.

The native path compiles csrc/parity_rng.cpp with g++ on first use into
``build/mettagrid_tpu_torch/parity_rng-<hash>.so`` at the root of the
checkout (the directory the CUDA kernels are built into,
engine/kernels/build.py), keyed by a hash of the source and the flags;
nothing is written into the package. The pure-Python fallback implements
MT19937 plus libstdc++ 12's Lemire-style uniform_int_distribution and
std::shuffle (/usr/include/c++/12/bits/uniform_int_dist.h: _S_nd;
bits/stl_algo.h std::shuffle draws one distribution value per swap,
i = n-1 .. 1). ``ReferenceRng.native`` says which one a stream runs on.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

SOURCE = Path(__file__).resolve().parent / "csrc" / "parity_rng.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mettagrid_tpu_torch"
GXX_FLAGS = ("-O2", "-std=c++20", "-shared", "-fPIC")

_LIB: Optional[ctypes.CDLL] = None
_LIB_FAILED = False


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"parity_rng-{h.hexdigest()[:16]}.so"


def _build_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_FAILED
    if _LIB is not None or _LIB_FAILED:
        return _LIB
    out = library_path()
    try:
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)], check=True, capture_output=True)
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        lib.mt_new.restype = ctypes.c_void_p
        lib.mt_new.argtypes = [ctypes.c_uint32]
        lib.mt_free.argtypes = [ctypes.c_void_p]
        lib.mt_next.restype = ctypes.c_uint32
        lib.mt_next.argtypes = [ctypes.c_void_p]
        lib.mt_uniform_int.restype = ctypes.c_uint64
        lib.mt_uniform_int.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64]
        lib.mt_shuffle.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
        lib.mt_skip.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        _LIB = lib
    except Exception:  # noqa: BLE001 - fall back to pure python
        _LIB_FAILED = True
    return _LIB


class _PyMT19937:
    """Pure-Python MT19937 (fallback; identical stream to std::mt19937)."""

    N, M = 624, 397
    MATRIX_A = 0x9908B0DF
    UPPER = 0x80000000
    LOWER = 0x7FFFFFFF

    def __init__(self, seed: int):
        self.mt = [0] * self.N
        self.mt[0] = seed & 0xFFFFFFFF
        for i in range(1, self.N):
            self.mt[i] = (1812433253 * (self.mt[i - 1] ^ (self.mt[i - 1] >> 30)) + i) & 0xFFFFFFFF
        self.idx = self.N

    def next(self) -> int:
        if self.idx >= self.N:
            for i in range(self.N):
                y = (self.mt[i] & self.UPPER) | (self.mt[(i + 1) % self.N] & self.LOWER)
                self.mt[i] = self.mt[(i + self.M) % self.N] ^ (y >> 1)
                if y & 1:
                    self.mt[i] ^= self.MATRIX_A
            self.idx = 0
        y = self.mt[self.idx]
        self.idx += 1
        y ^= y >> 11
        y ^= (y << 7) & 0x9D2C5680
        y ^= (y << 15) & 0xEFC60000
        y ^= y >> 18
        return y & 0xFFFFFFFF


class ReferenceRng:
    """std::mt19937 stream with libstdc++ shuffle/uniform_int semantics."""

    def __init__(self, seed: int):
        self._lib = _build_lib()
        if self._lib is not None:
            self._h = self._lib.mt_new(seed)
            self._py = None
        else:
            self._h = None
            self._py = _PyMT19937(seed)

    def __del__(self):  # pragma: no cover
        if getattr(self, "_lib", None) is not None and getattr(self, "_h", None):
            self._lib.mt_free(self._h)
            self._h = None

    @property
    def native(self) -> bool:
        return self._h is not None

    def next_u32(self) -> int:
        if self._h is not None:
            return self._lib.mt_next(self._h)
        return self._py.next()

    def uniform_int(self, a: int, b: int) -> int:
        """std::uniform_int_distribution<uint64_t>(a, b) — one value."""
        if self._h is not None:
            return self._lib.mt_uniform_int(self._h, a, b)
        return a + self._lemire(b - a + 1)

    def _lemire(self, range_: int) -> int:
        """libstdc++ 12 _S_nd for a 64-bit range over a 32-bit engine:
        the engine is widened via two draws when range > 2^32; for
        range <= 2^32 one 32-bit Lemire rejection loop."""
        if range_ <= (1 << 32):
            # _S_nd<W=uint64, U=uint32>
            u_digits = 32
            mask = (1 << 32) - 1
            product = self._py.next() * range_
            low = product & mask
            if low < range_:
                threshold = (-range_) % range_
                while low < threshold:
                    product = self._py.next() * range_
                    low = product & mask
            return product >> u_digits
        raise NotImplementedError("64-bit ranges need the native library")

    def shuffle(self, items: list) -> list:
        """libstdc++ std::shuffle order (in place; also returns the list)."""
        n = len(items)
        if n <= 1:
            return items
        if self._h is not None:
            import numpy as np

            arr = np.arange(n, dtype=np.int64)
            # shuffle indices natively, then apply
            buf = (ctypes.c_int64 * n)(*arr.tolist())
            self._lib.mt_shuffle(self._h, buf, n)
            order = list(buf)
            shuffled = [items[i] for i in order]
            items[:] = shuffled
            return items
        # libstdc++ std::shuffle (stl_algo.h:3694-3759): when
        # urngrange / n >= n, pairs of swap positions come from ONE
        # distribution draw over [0, b0*b1) (__gen_two_uniform_ints);
        # otherwise one draw per swap.
        urngrange = (1 << 32) - 1
        if urngrange // n >= n:
            i = 1
            if n % 2 == 0:
                j = self._lemire(2)
                items[i], items[j] = items[j], items[i]
                i += 1
            while i < n:
                b0 = i + 1
                b1 = i + 2
                x = self._lemire(b0 * b1)
                p0, p1 = x // b1, x % b1
                items[i], items[p0] = items[p0], items[i]
                i += 1
                items[i], items[p1] = items[p1], items[i]
                i += 1
            return items
        for i in range(1, n):
            j = self._lemire(i + 1)
            items[i], items[j] = items[j], items[i]
        return items

    def permutation(self, n: int) -> list[int]:
        return self.shuffle(list(range(n)))
