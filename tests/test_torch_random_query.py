"""order_by=random queries outside the reference-RNG step, in lockstep with
the JAX engine, exactly.

The tithe family (tools/bench_run.make_tithe_cfg: a tithe filter over two
shrines picked by an order_by=random query, and the enrich event with
max_targets) steps without ``reference_rng`` in both engines. Both take the
same actions and agent orders, drawn with numpy; the port takes the JAX
engine's own event ranks (as tests/test_torch_general.py feeds them) and its
query ranks through ``query_ranks``: per env, uniform ranks from the step key
folded with the query's ``rng_salt``, computed from the JAX state's ``rng``
as the reference's exec.py:779-780 draws them. Every output and every state
field but ``rng`` must be equal after every step (tolerance: exact; payloads
are integers, float stats and rewards sums of small integers).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import mettagrid_tpu.engine as jengine
from mettagrid_tpu_torch import engine as tengine
from mettagrid_tpu_torch.engine.ir import CompiledQuery
from tests.test_torch_general import _jax_draws
from tests.test_torch_reference_rng import build_both, small_cfg
from tests.test_torch_step import _assert_outputs_equal, _assert_states_equal, _jax_state_numpy


def random_query_salts(node, seen=None) -> set:
    """The rng_salt of every order_by=random query reachable from ``node``
    (a compiled program or any part of it)."""
    seen = set() if seen is None else seen
    if id(node) in seen or isinstance(node, (str, bytes, int, float, np.ndarray)) or node is None:
        return set()
    seen.add(id(node))
    out = set()
    if isinstance(node, CompiledQuery) and node.order_random:
        out.add(node.rng_salt)
    if isinstance(node, dict):
        node = list(node.values())
    if isinstance(node, (list, tuple)):
        for x in node:
            out |= random_query_salts(x, seen)
    elif dataclasses.is_dataclass(node):
        for f in dataclasses.fields(node):
            out |= random_query_salts(getattr(node, f.name), seen)
    return out


def jax_query_ranks(jstate, salts, N):
    """The JAX step's query ranks {salt: f32[E, N]}: uniform draws from its
    step key (the state's rng after the step) folded with each salt."""
    out = {}
    for salt in salts:
        keys = jax.vmap(lambda k: jax.random.fold_in(k, salt))(jstate.rng)
        out[salt] = torch.from_numpy(np.array(jax.vmap(lambda k: jax.random.uniform(k, (N,)))(keys)))
    return out


def test_tithe_random_query_matches_jax():
    """16 envs over 24 steps, across the enrich firing at step 10: the tithe
    filter evaluates its random query on every shrine bump, and pays."""
    E, n_steps = 16, 24
    cfg = small_cfg("tithe_rrng", 6, 11, 0)
    (jp, ji), (tp, ti) = build_both(cfg, [4])
    salts = random_query_salts(tp)
    assert salts == {1}
    A, N = tp.num_agents, ti.obj_type.shape[1]
    n_rows = len(jp.events)
    jstep = jengine.make_step(jp, ji, auto_reset=False, donate=False, external_perm=True)
    tstep = tengine.make_step(tp, ti, auto_reset=False, external_perm=True, device="cpu")
    jstate, jout = jengine.make_reset(jp, ji, E)(0)
    tstate, tout = tengine.make_reset(tp, ti, E, device="cpu")(0)
    _assert_states_equal(_jax_state_numpy(jstate), tstate, where="reset: ")
    jbuf, tbuf = jout.observations, tout.observations
    n_actions = len(tp.action_names)
    ore = tp.resource_names.index("ore_red")
    rng = np.random.default_rng(2)
    for i in range(n_steps):
        # Mostly moves, so agents bump shrines.
        acts = np.where(rng.random((E, A)) < 0.85, rng.integers(1, 5, (E, A)), rng.integers(-1, n_actions + 1, (E, A)))
        acts = acts.astype(np.int32)
        vib = np.zeros_like(acts)
        perm = np.stack([rng.permutation(A) for _ in range(E)]).astype(np.int32)
        _, ranks = _jax_draws(jstate, 1, n_rows, N)
        jstate, jout = jstep(jstate, jnp.asarray(acts), jnp.asarray(vib), jnp.asarray(perm), jbuf)
        tstate, tout = tstep(tstate, torch.from_numpy(acts), torch.from_numpy(vib), torch.from_numpy(perm), tbuf,
                             event_ranks=torch.from_numpy(ranks), query_ranks=jax_query_ranks(jstate, salts, N))
        _assert_outputs_equal(jout, tout, where=f"step {i}: ")
        _assert_states_equal(_jax_state_numpy(jstate), tstate, where=f"step {i}: ")
        jbuf, tbuf = jout.observations, tout.observations
    assert int(tstate.obj_inv[:, :A, ore].sum()) > 0, "the tithe handler never paid"
