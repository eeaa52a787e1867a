"""The event-filter arena family (an order_by=random query in the enrich
event's filter, drawn once per visited target): the port's run_arena_ours
against the JAX package on the CPU, the check of
tests/test_torch_arena_parity.py. The JAX package steps this family's
sequential per-target event walk in about 1-1.5 s per step on the CPU, so
the quick test compares its first 40 steps (the event fires at steps 10 and
35), with checkpoints every 10 steps and observations every 20, and the test
marked slow compares all 200 steps (the event's eight firings and the
MT19937 stream after them), with checkpoints every 10 steps and observations
every 100. The port also runs its 200 steps against itself on the card
(chip_smoke.py phase 49).
"""

import pytest

from tests.test_torch_arena_parity import check_family


def test_event_filter_rng_matches_jax():
    check_family("event_filter_rng", steps=40, checkpoint_every=10, compare_obs_every=20)


@pytest.mark.slow
def test_event_filter_rng_matches_jax_all_steps():
    check_family("event_filter_rng", checkpoint_every=10)
