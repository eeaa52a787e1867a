"""The port's ReferenceRng (parity/rng.py) against the JAX package's, and the
port's MT19937 twin (engine/mt19937.py) against the port's ReferenceRng.

- Twins: the same seeds, ranges and list lengths through both packages'
  ReferenceRng; raw draws across the 624-word twist, uniform_int,
  shuffle and permutation must be equal, with ``native`` asserted on both
  (g++ is on every machine that runs these tests, so a broken build cannot
  pass as the pure-Python stream). The port's pure-Python fallback is held
  to its native stream as well.
- The port's engine twin against the port's ReferenceRng: the cases of
  tests/test_mt19937.py (raw stream across the twist, uniform_int over the
  ranges of that file, std::shuffle permutations for n in 2..16 with the
  next raw draw after them, per-env masking, shuffles of mixed parity), on
  CPU tensors. The ranges are the JAX file's in full: on the port's eager
  twin they take seconds, not the minute its parity-marked sweep takes.

Tolerance: exact (integers).
"""

import numpy as np
import pytest
import torch

from mettagrid_tpu.parity.rng import ReferenceRng as JaxReferenceRng
from mettagrid_tpu_torch.engine.mt19937 import mt_init, mt_next, shuffle_perm, uniform_int
from mettagrid_tpu_torch.parity import ReferenceRng
from mettagrid_tpu_torch.parity import rng as rng_mod

SEEDS = [5489, 0, 12345, 2**32 - 1, 7, 99]
RANGES = [1, 2, 5, 23, 24, 600, 65535, 10**6]


def _pair(seed):
    t, j = ReferenceRng(seed), JaxReferenceRng(seed)
    assert t.native and j.native, "the native reference RNG did not build"
    return t, j


def test_library_is_built_outside_the_package():
    path = rng_mod.library_path()
    assert ReferenceRng(1).native and path.exists()
    assert path.parent == rng_mod.BUILD_DIR and path.parent.parts[-2:] == ("build", "mettagrid_tpu_torch")
    package = rng_mod.SOURCE.parents[1]
    assert not list(package.glob("*.so")) and not list(package.rglob("_parity_rng*"))


@pytest.mark.parametrize("seed", SEEDS)
def test_raw_stream_matches_jax_reference(seed):
    t, j = _pair(seed)
    assert [t.next_u32() for _ in range(700)] == [j.next_u32() for _ in range(700)]


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_uniform_int_matches_jax_reference(seed):
    t, j = _pair(seed)
    for hi in RANGES + [2**32 - 1, 2**32, 2**40]:
        for _ in range(20):
            assert t.uniform_int(0, hi) == j.uniform_int(0, hi), hi
    assert t.next_u32() == j.next_u32()


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_shuffle_and_permutation_match_jax_reference(seed):
    t, j = _pair(seed)
    rng = np.random.default_rng(seed % 1000)
    for n in [0, 1, 2, 3, 16, 24, 97]:
        items = [f"x{v}" for v in rng.integers(0, 100, n)]
        assert t.shuffle(list(items)) == j.shuffle(list(items)), n
        assert t.permutation(n) == j.permutation(n), n
    assert t.next_u32() == j.next_u32()


def test_pure_python_fallback_matches_native():
    """The fallback (used where g++ is missing) draws the native stream."""
    native = ReferenceRng(42)
    fallback = ReferenceRng(42)
    fallback._h, fallback._py = None, rng_mod._PyMT19937(42)
    assert native.native and not fallback.native
    assert [native.next_u32() for _ in range(650)] == [fallback.next_u32() for _ in range(650)]
    for hi in RANGES:
        assert [native.uniform_int(0, hi) for _ in range(5)] == [fallback.uniform_int(0, hi) for _ in range(5)]
    for n in (2, 7, 24, 97):
        assert native.permutation(n) == fallback.permutation(n), n


def _state(seeds):
    return mt_init(torch.tensor(seeds, dtype=torch.int64))


def _all(n):
    return torch.ones(n, dtype=torch.bool)


def test_engine_twin_raw_stream_across_twist():
    seeds = SEEDS[:4]
    state = _state(seeds)
    refs = [ReferenceRng(s) for s in seeds]
    assert all(r.native for r in refs)
    for i in range(700):
        state, u = mt_next(state, _all(4))
        assert u.tolist() == [r.next_u32() for r in refs], i


def test_engine_twin_uniform_int():
    seeds = [7, 99]
    state = _state(seeds)
    refs = [ReferenceRng(s) for s in seeds]
    for hi in RANGES:
        for _ in range(20):
            state, x = uniform_int(state, torch.full((2,), hi + 1, dtype=torch.int64), _all(2))
            assert x.tolist() == [r.uniform_int(0, hi) for r in refs], hi


def test_engine_twin_shuffle_matches_std_shuffle():
    for n in range(2, 17):
        seeds = [n * 31 + 1, n * 31 + 2]
        state = _state(seeds)
        refs = [ReferenceRng(s) for s in seeds]
        state, perm = shuffle_perm(state, torch.full((2,), n, dtype=torch.int64), 20, _all(2))
        for e, ref in enumerate(refs):
            assert perm[e, :n].tolist() == ref.permutation(n), (n, e)
            assert perm[e, n:].tolist() == list(range(n, 20)), "tail stays identity"
        state, u = mt_next(state, _all(2))
        assert u.tolist() == [r.next_u32() for r in refs], ("post-shuffle drift", n)


def test_engine_twin_masking_freezes_inactive_envs():
    state = _state([11, 11])
    for _ in range(5):
        state, _ = mt_next(state, torch.tensor([True, False]))
    state, u = mt_next(state, _all(2))
    fresh = ReferenceRng(11)
    for _ in range(5):
        fresh.next_u32()
    assert int(u[0]) == fresh.next_u32()
    assert int(u[1]) == ReferenceRng(11).next_u32()


def test_engine_twin_mixed_parity_shuffles():
    seeds, ns = [3, 4], [6, 7]
    state = _state(seeds)
    state, perm = shuffle_perm(state, torch.tensor(ns, dtype=torch.int64), 10, _all(2))
    state, u = mt_next(state, _all(2))
    for e, (s, n) in enumerate(zip(seeds, ns)):
        ref = ReferenceRng(s)
        assert perm[e, :n].tolist() == ref.permutation(n)
        assert int(u[e]) == ref.next_u32()
