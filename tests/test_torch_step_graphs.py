"""The step replayed as CUDA graphs (engine/step_graphs.py) against the same step on the CPU.

On the card (marker ``cuda``; skipped without a CUDA device): the arena at
64 envs with a pool of 4 maps and 40-step episodes, stepped 300 times from
one reset by the step built for the CPU (eager) and by the step built for
the card (graphs) with the same agent orders and reset maps. Every state
field and output is held equal at every step, the graph step's host reads
to its waves and its B1 launches to its calls. A call given a state other
than the graph step's own, and a call given an observation buffer of the
caller's, match the CPU step, the buffer holding the observations. A
pure-move program with a raycast reward, whose capture meets a host read,
stays eager and equal to the CPU step. On the CPU: the predicate
``graphs_ok`` that decides which programs take graphs.
"""

import warnings

import pytest
import torch

from mettagrid_tpu_torch.engine import EnvState, compile_program, make_reset, make_step
from mettagrid_tpu_torch.engine.actions_fast import PURE_UNROLL_WAVES
from mettagrid_tpu_torch.engine.kernels.obs_tail_static_v2 import obs_tail_static_v2
from mettagrid_tpu_torch.engine.step import graphs_ok
from mettagrid_tpu_torch.profiling import trace
from mettagrid_tpu_torch.tools.bench_run import build_pool, make_cfg

E = 64
POOL = 4
MAX_STEPS = 40
STEPS = 300


@pytest.mark.parametrize(
    "variant, device, reference_rng, takes",
    [
        ("flagship", "cuda", False, True),
        ("general", "cuda", False, False),
        ("full_combat", "cuda", False, False),
        ("tithe_rrng", "cuda", True, False),
        ("flagship", "cpu", False, False),
    ],
)
def test_which_programs_take_graphs(variant, device, reference_rng, takes):
    program = compile_program(make_cfg(variant))
    assert graphs_ok(program, device, reference_rng=reference_rng) is takes


def _delta(before: dict, after: dict, name: str) -> int:
    return after.get(name, {}).get("count", 0) - before.get(name, {}).get("count", 0)


def _same(a, b) -> list:
    """The names of the fields of two named tuples of tensors (``a`` on the
    CPU) that differ."""
    return [k for k, x, y in zip(a._fields, a, b) if not torch.equal(x, y.cpu())]


def _inputs(gen, n_actions: int, A: int, dev) -> tuple:
    """One step's actions, agent order and reset maps, on the CPU and on ``dev``."""
    acts = torch.randint(0, n_actions, (E, A), generator=gen, dtype=torch.int32)
    perm = torch.rand((E, A), generator=gen).argsort(dim=1).to(torch.int32)
    maps = torch.randint(0, POOL, (E,), generator=gen, dtype=torch.int32)
    return (acts, perm, maps), tuple(x.to(dev) for x in (acts, perm, maps))


@pytest.mark.cuda
def test_graph_step_matches_the_eager_step():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    program, init = build_pool(make_cfg("flagship"), POOL, max_steps=MAX_STEPS)
    assert graphs_ok(program, dev)
    eager = make_step(program, init, auto_reset=True, external_perm=True, device="cpu")
    graph = make_step(program, init, auto_reset=True, external_perm=True, device=dev)
    assert graph.obs_fn.route == "B1"
    gen = torch.Generator()
    gen.manual_seed(7)
    A, n_actions = program.num_agents, len(program.action_names)
    se, oe = make_reset(program, init, E, device="cpu")(3)
    sg, og = make_reset(program, init, E, device=dev)(3)
    vibes_cpu = torch.zeros((E, A), dtype=torch.int32)
    vibes = vibes_cpu.to(dev)
    past_unrolled = ended = 0
    before_all = trace.snapshot()
    launches = obs_tail_static_v2.launches
    for i in range(STEPS):
        (acts_c, perm_c, maps_c), (acts, perm, maps) = _inputs(gen, n_actions, A, dev)
        se, oe = eager(se, acts_c, vibes_cpu, perm_c, oe.observations, maps_c)
        buf = og.observations
        if i == STEPS // 2:
            # A state that is not the graph step's own is copied in.
            sg = EnvState(*(t.clone() for t in sg))
        if i == STEPS // 3:
            # An observation buffer of the caller's gets the observations.
            adopted, buf = buf, buf.clone()
        elif i == STEPS // 3 + 1:
            buf = adopted
        before = trace.snapshot()
        sg, og = graph(sg, acts, vibes, perm, buf, maps)
        after = trace.snapshot()
        assert not _same(se, sg), f"step {i + 1}: state fields differ: {_same(se, sg)}"
        assert not _same(oe, og), f"step {i + 1}: outputs differ: {_same(oe, og)}"
        assert og.observations is buf
        if i:
            waves = _delta(before, after, "actions.waves")
            assert _delta(before, after, "step.graph_replays") == 1
            assert _delta(before, after, "host_syncs") == _delta(before, after, "host_syncs.actions.pure_waves")
            assert _delta(before, after, "host_syncs") == waves - 1
            past_unrolled += waves > PURE_UNROLL_WAVES
        ended += bool((og.terminals | og.truncations).any())
    assert _delta(before_all, trace.snapshot(), "step.graph_replays") == STEPS - 1
    assert obs_tail_static_v2.launches - launches == STEPS, "a replay launches B1 once"
    assert past_unrolled > 0, "no step ran past the unrolled waves"
    assert ended >= STEPS // MAX_STEPS - 1


def _raycast_reward(cfg):
    """A per-tick reward counting what rays from the agents meet: a raycast
    query, which reads the host."""
    from mettagrid_tpu_torch.config.game_value import QueryCountValue
    from mettagrid_tpu_torch.config.handler_config import isA
    from mettagrid_tpu_torch.config.query import RaycastQuery
    from mettagrid_tpu_torch.config.reward_config import reward
    from mettagrid_tpu_torch.config.tag import typeTag

    ray = RaycastQuery(source=typeTag("agent"), max_range=3, blocker=[isA("wall")])
    cfg.game.agent.rewards["rays"] = reward(QueryCountValue(query=ray.model_dump()), per_tick=True)
    return cfg


@pytest.mark.cuda
def test_a_capture_that_reads_the_host_stays_eager():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    program, init = build_pool(_raycast_reward(make_cfg("flagship")), POOL, max_steps=MAX_STEPS)
    assert graphs_ok(program, dev)
    eager = make_step(program, init, auto_reset=True, external_perm=True, device="cpu")
    graph = make_step(program, init, auto_reset=True, external_perm=True, device=dev)
    gen = torch.Generator()
    gen.manual_seed(8)
    A, n_actions = program.num_agents, len(program.action_names)
    se, oe = make_reset(program, init, E, device="cpu")(4)
    sg, og = make_reset(program, init, E, device=dev)(4)
    vibes_cpu = torch.zeros((E, A), dtype=torch.int32)
    vibes = vibes_cpu.to(dev)
    before = trace.snapshot()
    paid = 0.0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for i in range(12):
            (acts_c, perm_c, maps_c), (acts, perm, maps) = _inputs(gen, n_actions, A, dev)
            se, oe = eager(se, acts_c, vibes_cpu, perm_c, oe.observations, maps_c)
            sg, og = graph(sg, acts, vibes, perm, og.observations, maps)
            assert not _same(se, sg), f"step {i + 1}: state fields differ: {_same(se, sg)}"
            assert not _same(oe, og), f"step {i + 1}: outputs differ: {_same(oe, og)}"
            paid += float(oe.rewards.abs().sum())
    after = trace.snapshot()
    # The host read ends the capture quietly; only a refused operation warns.
    assert not [w for w in caught if "stays eager" in str(w.message)]
    assert _delta(before, after, "step.graph_replays") == 0
    assert _delta(before, after, "host_syncs.query.raycast_sources") > 0
    assert paid > 0, "the raycast reward never paid"
