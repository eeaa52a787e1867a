"""The filter kinds max_distance, not, or, periodic and query_resource
against the JAX engine, exactly.

One case per kind, each in the small arena of
tests/test_torch_mutation_kinds.py (whose helpers and harness this file
shares): the kind gates the first move handler and an event's or an agent
on_tick handler's mutations. The JAX engine steps with its sequential
action phase, the port with its own choice (waves where fast_mode_ok
holds, which must agree with the reference's gate; max_distance with
radius 2 takes the line scan and the Chebyshev waves), over the same
actions and agent orders; every output and state field but ``rng`` must be
equal after every step. Also a reference-RNG case: an ``or`` filter whose
second alternative holds an order_by=random query draws from the MT19937
twin only where the first failed, as the C++ OrFilter short-circuits; both
engines compare ``mt``. Tolerance: exact.
"""

import pytest
import torch

from mettagrid_tpu_torch import engine as tengine
from mettagrid_tpu_torch.config.game_value import QueryInventoryValue
from mettagrid_tpu_torch.config.handler_config import EntityTarget, GameValueFilter, HandlerTarget, OrFilter
from mettagrid_tpu_torch.config.query import Query
from mettagrid_tpu_torch.config.tag import typeTag
from tests.test_torch_mutation_kinds import A, E, FILTERS, _base_cfg, _delta, _has, _move, check_kind
from tests.test_torch_reference_rng import build_both, lockstep


@pytest.mark.parametrize("kind", FILTERS)
def test_kind_matches_jax(kind):
    """The port's phase against the JAX engine's sequential phase; the
    kind's handlers must have applied."""
    check_kind(kind)


def test_or_filter_draws_under_reference_rng():
    """An ``or`` filter whose second alternative holds an order_by=random
    query (two chests picked at random must hold 3 ore between them), under
    the reference-RNG step: the query draws from the MT19937 twin only where
    the first alternative failed, as the C++ OrFilter short-circuits. Both
    engines take the sequential phase and compare ``mt``."""
    cfg = _base_cfg()
    picked = QueryInventoryValue(query=Query(source=typeTag("chest"), order_by="random", max_items=2).model_dump(),
                                 item="ore_red")
    cfg.game.actions.move.handlers = [
        _move("lucky", [_delta(EntityTarget.ACTOR, heart=1), _delta(EntityTarget.TARGET, ore_red=1)],
              [OrFilter(inner=[_has(HandlerTarget.ACTOR, heart=7), GameValueFilter(target=HandlerTarget.ACTOR, value=picked, min=3)])]),
    ]
    both = build_both(cfg, [7])
    state = lockstep(*both, E=E, n_steps=10, seed=2, reference_rng=True, perm=False, vibes=False)
    # The agent shuffles alone leave the twins elsewhere: the query drew.
    tp, ti = both[1]
    step = tengine.make_step(tp, ti, auto_reset=False, reference_rng=True, device="cpu", action_mode="sequential")
    assert step.action_phase_kind == "sequential"
    shuffles_only, _ = tengine.make_reset(tp, ti, E, reference_rng=True, device="cpu")(0)
    noop = torch.zeros((E, A), dtype=torch.int32)
    for _ in range(10):
        shuffles_only, _ = step(shuffles_only, noop, noop)
    assert not torch.equal(state.mt, shuffles_only.mt), "the query never drew"
    assert int(state.obj_inv[:, :A, tp.resource_names.index("heart")].sum()) > 6 * A * E, "the handler never applied"
