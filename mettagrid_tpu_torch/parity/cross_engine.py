"""Cross-engine parity: step this engine and the reference C++ engine on
matched configs/actions and diff their states
(twin of the JAX package's parity/cross_engine.py).

The signature-match rate against the C++ reference is counted from these
scenarios. Scenarios are expressed once as plain data (map rows +
object/action specs + action scripts); because this engine's config API
mirrors the reference's field-for-field, ONE builder constructs the scenario
in either engine through a resolved module namespace (`_Api`), which
guarantees the configs are actually identical.

Per step the trace records action_success, agent (r, c), agent inventory,
and optionally observation tokens; at the end, the canonical object/reward
state. Object comparison is position-keyed (slot ids are engine-internal).
``run_ours`` runs on the CUDA device unless asked for another (device="cpu"
for the plain path); ``run_reference`` needs the oracle
(parity/reference_oracle.py) and is the only caller of ``mettagrid``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

_SUMMARY_FIELDS = ("obj_alive", "obj_type", "obj_r", "obj_c", "obj_vibe", "obj_inv", "episode_rewards")


@dataclass
class Scenario:
    """Engine-neutral description of a parity scenario."""

    map_data: List[List[str]]  # ObjectNameMapBuilder cell names
    num_agents: int
    scripts: List[List[str]]  # scripts[t][agent] = action name at step t
    objects: Dict[str, Any] = field(default_factory=dict)  # name -> spec dict
    agent_rewards: Dict[str, float] = field(default_factory=dict)
    attack: Optional[Dict[str, Any]] = None  # AttackActionConfig fields
    # Custom move handlers — the reference's LIVE combat path (vibe-gated
    # handler + C++ AttackMutationConfig via handler_bindings.hpp:544).
    # Each spec: {"name", "actor_vibe", "direct_attack": {"weapon", "armor",
    # "health", "pct"}}.
    move_handlers: List[Dict[str, Any]] = field(default_factory=list)
    change_vibe: bool = True
    inventories: Dict[int, Dict[str, int]] = field(default_factory=dict)
    # Agent shared inventory limits: {limit_name: {"base": n, "resources": [..],
    # "modifiers": {res: w}}} — exercises the clamp math cross-engine.
    agent_limits: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    max_steps: int = 1000
    resources: Optional[List[str]] = None
    # Timestep events: {name: {"target_type", "timesteps", "max_targets"?,
    # "mutations": [{"kind": "raycast_spawn", "object_type", "directions",
    # "max_range", "blocker_types"?: [...]} | {"kind": "update_target",
    # "deltas": {...}}]}}
    events: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    compare_obs: bool = False
    # Feed the reference's MT19937 std::shuffle agent order into our engine
    # (required whenever agents can contend — the winner is order-dependent).
    reference_shuffle: bool = False
    seed: int = 0


class _Api:
    """The config/simulation symbols of one framework, resolved by name.

    Both packages expose the same class names with the same fields (ours is
    modeled on the reference's pydantic layer), so scenario construction is
    written once against this namespace.
    """

    def __init__(self, ours: bool):
        self.ours = ours
        if ours:
            from mettagrid_tpu_torch.config import action_config as A
            from mettagrid_tpu_torch.config import game_config as G
            from mettagrid_tpu_torch.config import handler_config as H
            from mettagrid_tpu_torch.config import reward_config as R
            from mettagrid_tpu_torch.test_support import ObjectNameMapBuilder

            self.MettaGridConfig = G.MettaGridConfig
            self.GameConfig = G.GameConfig
            self.AgentConfig = G.AgentConfig
            self.GridObjectConfig = G.GridObjectConfig
            self.WallConfig = G.WallConfig
            self.Handler = H.Handler
            self.EntityTarget = H.EntityTarget
            self.ResourceDeltaMutation = H.ResourceDeltaMutation
            self.VibeFilter = H.VibeFilter
            self.HandlerTarget = H.HandlerTarget
            self.ActionsConfig = A.ActionsConfig
            self.NoopActionConfig = A.NoopActionConfig
            self.MoveActionConfig = A.MoveActionConfig
            self.AttackActionConfig = A.AttackActionConfig
            self.AttackOutcome = A.AttackOutcome
            self.ChangeVibeActionConfig = A.ChangeVibeActionConfig
            self.inventoryReward = R.inventoryReward
            self.ObjectNameMapBuilder = ObjectNameMapBuilder
            from mettagrid_tpu_torch.config.event_config import EventConfig
            from mettagrid_tpu_torch.config.handler_config import (
                RaycastSpawnMutation,
                isA,
                updateTarget,
            )
            from mettagrid_tpu_torch.config.tag import typeTag

            self.EventConfig = EventConfig
            self.RaycastSpawnMutation = RaycastSpawnMutation
            self.updateTarget = updateTarget
            self.isA = isA
            self.typeTag = typeTag
        else:
            from mettagrid_tpu_torch.parity.reference_oracle import load_reference

            load_reference()
            from mettagrid.config import action_config as A
            from mettagrid.config import handler_config as H
            from mettagrid.config import mettagrid_config as G
            from mettagrid.config import mutation as MU
            from mettagrid.config import reward_config as R
            from mettagrid.test_support.map_builders import ObjectNameMapBuilder

            from mettagrid.config import filter as F

            self.MettaGridConfig = G.MettaGridConfig
            self.GameConfig = G.GameConfig
            self.AgentConfig = G.AgentConfig
            self.GridObjectConfig = G.GridObjectConfig
            self.WallConfig = G.WallConfig
            self.Handler = H.Handler
            self.EntityTarget = MU.EntityTarget
            self.ResourceDeltaMutation = MU.ResourceDeltaMutation
            self.VibeFilter = F.VibeFilter
            self.HandlerTarget = F.HandlerTarget
            self.ActionsConfig = A.ActionsConfig
            self.NoopActionConfig = A.NoopActionConfig
            self.MoveActionConfig = A.MoveActionConfig
            self.AttackActionConfig = A.AttackActionConfig
            self.AttackOutcome = A.AttackOutcome
            self.ChangeVibeActionConfig = A.ChangeVibeActionConfig
            self.inventoryReward = R.inventoryReward
            self.ObjectNameMapBuilder = ObjectNameMapBuilder
            from mettagrid.config.event_config import EventConfig
            from mettagrid.config.filter import isA
            from mettagrid.config.handler_config import updateTarget
            from mettagrid.config.mutation import RaycastSpawnMutation
            from mettagrid.config.tag import typeTag

            self.EventConfig = EventConfig
            self.RaycastSpawnMutation = RaycastSpawnMutation
            self.updateTarget = updateTarget
            self.isA = isA
            self.typeTag = typeTag


def _build_config(api: _Api, sc: Scenario):
    objects: Dict[str, Any] = {"wall": api.WallConfig()}
    for name, spec in sc.objects.items():
        if spec.get("kind") == "plain":
            objects[name] = api.GridObjectConfig(name=name, map_name=name)
        elif spec.get("kind") == "mine":
            objects[name] = api.GridObjectConfig(
                name=name,
                map_name=name,
                on_use_handler=api.Handler(
                    name=f"{name}_use",
                    mutations=[
                        api.ResourceDeltaMutation(
                            target=api.EntityTarget.ACTOR, deltas=dict(spec["gives"])
                        )
                    ],
                ),
            )

    agent_kwargs: Dict[str, Any] = dict(
        rewards={
            f"inv_{res}": api.inventoryReward(res, weight=scale)
            for res, scale in sc.agent_rewards.items()
        }
    )
    if sc.agent_limits:
        if api.ours:
            from mettagrid_tpu_torch.config.game_config import InventoryConfig, ResourceLimitsConfig
        else:
            from mettagrid.config.mettagrid_config import InventoryConfig, ResourceLimitsConfig
        agent_kwargs["inventory"] = InventoryConfig(
            limits={name: ResourceLimitsConfig(**spec) for name, spec in sc.agent_limits.items()}
        )
    agent = api.AgentConfig(**agent_kwargs)

    move_handlers = []
    for spec in sc.move_handlers:
        filters = []
        if spec.get("actor_vibe"):
            filters.append(
                api.VibeFilter(target=api.HandlerTarget.ACTOR, vibe=spec["actor_vibe"])
            )
        mutations = []
        if api.ours and spec.get("direct_attack"):
            # The reference side attaches the bound C++ AttackMutationConfig
            # post-conversion (see run_reference) because the reference's own
            # convert_mutations silently drops its Python AttackMutation.
            from mettagrid_tpu_torch.config.handler_config import DirectAttackMutation

            da = spec["direct_attack"]
            mutations.append(
                DirectAttackMutation(
                    weapon_resource=da["weapon"],
                    armor_resource=da["armor"],
                    health_resource=da["health"],
                    damage_multiplier_pct=da.get("pct", 100),
                )
            )
        move_handlers.append(api.Handler(name=spec["name"], filters=filters, mutations=mutations))

    kwargs: Dict[str, Any] = dict(
        num_agents=sc.num_agents,
        max_steps=sc.max_steps,
        objects=objects,
        agent=agent,
        map_builder=api.ObjectNameMapBuilder.Config(map_data=sc.map_data),
    )
    if sc.attack is not None or not sc.change_vibe or move_handlers:
        attack_spec = dict(sc.attack or {})
        success = api.AttackOutcome(**attack_spec.pop("success", {}))
        kwargs["actions"] = api.ActionsConfig(
            noop=api.NoopActionConfig(),
            move=api.MoveActionConfig(handlers=move_handlers),
            attack=(
                api.AttackActionConfig(success=success, **attack_spec)
                if sc.attack is not None
                else api.AttackActionConfig(enabled=False)
            ),
            change_vibe=api.ChangeVibeActionConfig(enabled=sc.change_vibe),
        )
    if sc.events:
        events = {}
        for ename, espec in sc.events.items():
            mutations = []
            for m in espec["mutations"]:
                if m["kind"] == "raycast_spawn":
                    mutations.append(
                        api.RaycastSpawnMutation(
                            object_type=m["object_type"],
                            directions=list(m["directions"]),
                            max_range=m["max_range"],
                            blocker=[api.isA(t) for t in m.get("blocker_types", [])],
                        )
                    )
                elif m["kind"] == "update_target":
                    mutations.append(api.updateTarget(dict(m["deltas"])))
                else:
                    raise ValueError(f"unknown event mutation kind {m['kind']!r}")
            ekw = dict(
                name=ename,
                target_query=api.typeTag(espec["target_type"]),
                timesteps=list(espec["timesteps"]),
                mutations=mutations,
            )
            if espec.get("max_targets") is not None:
                ekw["max_targets"] = espec["max_targets"]
            events[ename] = api.EventConfig(**ekw)
        kwargs["events"] = events
    game = api.GameConfig(**kwargs)
    if sc.resources is not None:
        game = game.model_copy(update={"resource_names": list(sc.resources)})
    return api.MettaGridConfig(game=game)


def run_ours(sc: Scenario, device=None) -> Dict[str, Any]:
    """The scenario on this engine: a Simulation on ``device`` (CUDA unless
    the caller names another; without a card it raises unless
    device="cpu"). The trace also names the observation route taken."""
    from mettagrid_tpu_torch.simulator import Simulation

    cfg = _build_config(_Api(ours=True), sc)
    if sc.inventories:
        # Host-injected loadouts exceed the config-reachable token bound;
        # widen the obs pipeline so observations stay complete (the
        # reference has no static bound to widen).
        cfg.game.obs.full_token_bounds = True
    sim = Simulation(cfg, seed=sc.seed, reference_shuffle=sc.reference_shuffle, device=device)
    trace = _drive(sim, sc, ours=True)
    trace["final"] = _summary_ours(sim)
    trace["route"] = sim._step_fn.obs_fn.route
    return trace


def run_reference(sc: Scenario) -> Dict[str, Any]:
    from mettagrid_tpu_torch.parity.reference_oracle import load_reference

    load_reference()
    import mettagrid.config.mettagrid_c_config as mcc
    from mettagrid.simulator.simulator import Simulator

    cfg = _build_config(_Api(ours=False), sc)

    # The reference's convert_mutations has no AttackMutation branch (it is
    # silently dropped), so its live combat path is the bound C++ config
    # attached directly (handler_bindings.hpp:544 add_attack_mutation). Patch
    # the converter to attach it to the named move handlers.
    attack_by_handler = {
        s["name"]: s["direct_attack"] for s in sc.move_handlers if s.get("direct_attack")
    }
    orig_convert = mcc.convert_mutations
    if attack_by_handler:
        from mettagrid.mettagrid_c import AttackMutationConfig as CppAttackMutationConfig

        def patched(mutations, target_obj, id_maps, context=""):
            orig_convert(mutations, target_obj, id_maps, context)
            for name, da in attack_by_handler.items():
                if context == f"handler '{name}'":
                    target_obj.add_attack_mutation(
                        CppAttackMutationConfig(
                            weapon_resource=id_maps.resource_name_to_id[da["weapon"]],
                            armor_resource=id_maps.resource_name_to_id[da["armor"]],
                            health_resource=id_maps.resource_name_to_id[da["health"]],
                            damage_multiplier_pct=da.get("pct", 100),
                        )
                    )

        mcc.convert_mutations = patched
    try:
        sim = Simulator().new_simulation(cfg, seed=sc.seed)
    finally:
        mcc.convert_mutations = orig_convert
    trace = _drive(sim, sc, ours=False)
    trace["final"] = _summary_reference(sim)
    return trace


def _obs_tokens(obs_row) -> List[List[int]]:
    """Observation rows as a canonically sorted token list (drop empties).

    Sorted because within-cell inventory token order follows unordered_map
    iteration in the reference (SURVEY.md §3.3) — order is not part of the
    contract, membership is.
    """
    toks = [
        [int(a), int(b), int(c)] for a, b, c in obs_row if int(a) != 0xFF
    ]
    toks.sort()
    return toks


def _drive(sim, sc: Scenario, ours: bool) -> Dict[str, Any]:
    import numpy as np
    import torch

    for i, inv in sc.inventories.items():
        sim.agent(i).set_inventory(inv)
    steps = []
    for t, row in enumerate(sc.scripts):
        for i, action in enumerate(row):
            sim.agent(i).set_action(action)
        sim.step()
        if ours:
            success = [bool(x) for x in sim.last_outputs.action_success[0].cpu().numpy()]
            rc = torch.stack([sim.state.obj_r[0, : sc.num_agents], sim.state.obj_c[0, : sc.num_agents]]).cpu()
            pos = [(int(r), int(c)) for r, c in zip(*rc.tolist())]
            inv = [dict(sim.agent(i).inventory) for i in range(sc.num_agents)]
            obs_arr = sim.last_outputs.observations[0].cpu().numpy() if sc.compare_obs else None
        else:
            success = [bool(x) for x in np.asarray(sim.action_success)]
            gos = sim.grid_objects()
            by_agent = {
                int(o["agent_id"]): o for o in gos.values() if o.get("agent_id") is not None
            }
            resource_names = list(sim.resource_names)
            pos = [
                (int(by_agent[i]["r"]), int(by_agent[i]["c"])) for i in range(sc.num_agents)
            ]
            inv = [
                {
                    (resource_names[int(k)] if str(k).isdigit() else str(k)): int(v)
                    for k, v in (by_agent[i].get("inventory", {}) or {}).items()
                    if int(v) != 0
                }
                for i in range(sc.num_agents)
            ]
            obs_arr = np.asarray(sim._c_sim.observations()) if sc.compare_obs else None
        entry = {"t": t, "success": success, "pos": pos, "inv": inv}
        if obs_arr is not None:
            entry["obs"] = [_obs_tokens(obs_arr[i]) for i in range(sc.num_agents)]
        steps.append(entry)
    return {"steps": steps}


def _stats_payload(stats: Dict[str, Any]) -> Dict[str, Any]:
    """Episode stats as name-sorted (name, rounded value) pair lists — the
    shape the reference signature script hashes
    (scripts/deterministic_episode_signature.py:40-47; to_dict is a
    std::map, so .items() iterates name-sorted)."""
    return {
        "game": [(name, round(float(v), 5)) for name, v in sorted(stats["game"].items())],
        "agent": [
            [(name, round(float(v), 5)) for name, v in sorted(agent.items())]
            for agent in stats["agent"]
        ],
    }


def _summary_ours(sim) -> Dict[str, Any]:
    """The end state of env 0 (objects by position, rewards, episode stats),
    its fields read in one device-to-host copy."""
    from mettagrid_tpu_torch.simulator.stats import host_rows

    program = sim.program
    rows = {
        name: row[0]
        for name, row in host_rows(
            {name: getattr(sim.state, name) for name in _SUMMARY_FIELDS}, [0]
        ).items()
    }
    objs = []
    for slot in range(rows["obj_type"].shape[0]):
        if not rows["obj_alive"][slot]:
            continue
        objs.append(
            {
                "type": program.type_names[int(rows["obj_type"][slot])],
                "r": int(rows["obj_r"][slot]),
                "c": int(rows["obj_c"][slot]),
                "vibe": int(rows["obj_vibe"][slot]),
                "inventory": {
                    program.resource_names[r]: int(q)
                    for r, q in enumerate(rows["obj_inv"][slot])
                    if q != 0
                },
            }
        )
    objs.sort(key=lambda o: (o["r"], o["c"], o["type"]))
    return {
        "objects": objs,
        "episode_rewards": [round(float(x), 5) for x in rows["episode_rewards"]],
        "stats": _stats_payload(sim.episode_stats),
    }


def _summary_reference(ref_sim) -> Dict[str, Any]:
    import numpy as np

    resource_names = list(ref_sim.resource_names)
    objs = []
    for _oid, obj in sorted(ref_sim.grid_objects().items()):
        inv = obj.get("inventory", {}) or {}
        objs.append(
            {
                "type": str(obj["type_name"]),
                "r": int(obj["r"]),
                "c": int(obj["c"]),
                "vibe": int(obj.get("vibe", 0)),
                "inventory": {
                    (resource_names[int(k)] if str(k).isdigit() else str(k)): int(v)
                    for k, v in inv.items()
                    if int(v) != 0
                },
            }
        )
    objs.sort(key=lambda o: (o["r"], o["c"], o["type"]))
    return {
        "objects": objs,
        "episode_rewards": [round(float(x), 5) for x in np.asarray(ref_sim.episode_rewards)],
        "stats": _stats_payload(ref_sim._c_sim.get_episode_stats()),
    }


def diff_traces(a: Dict[str, Any], b: Dict[str, Any]) -> List[str]:
    """Human-readable mismatch list between run_ours and run_reference output."""
    problems = []
    for sa, sb in zip(a["steps"], b["steps"]):
        for key in ("success", "pos", "inv"):
            if sa[key] != sb[key]:
                problems.append(f"step {sa['t']}: {key} ours={sa[key]} ref={sb[key]}")
        if "obs" in sa and "obs" in sb and sa["obs"] != sb["obs"]:
            for i, (oa, ob) in enumerate(zip(sa["obs"], sb["obs"])):
                if oa != ob:
                    only_ours = [t for t in oa if t not in ob]
                    only_ref = [t for t in ob if t not in oa]
                    problems.append(
                        f"step {sa['t']} agent {i} obs: only_ours={only_ours[:8]} "
                        f"only_ref={only_ref[:8]}"
                    )
    for key in ("objects", "episode_rewards"):
        if a["final"][key] != b["final"][key]:
            problems.append(f"final {key}: ours={a['final'][key]} ref={b['final'][key]}")
    sa, sb = a["final"].get("stats"), b["final"].get("stats")
    if sa is not None and sb is not None and sa != sb:
        if sa["game"] != sb["game"]:
            oa, ob = dict(sa["game"]), dict(sb["game"])
            keys = sorted(set(oa) | set(ob))
            problems.append(
                "final game stats: "
                + "; ".join(
                    f"{k}: ours={oa.get(k)} ref={ob.get(k)}" for k in keys if oa.get(k) != ob.get(k)
                )
            )
        for i, (pa, pb) in enumerate(zip(sa["agent"], sb["agent"])):
            if pa != pb:
                oa, ob = dict(pa), dict(pb)
                keys = sorted(set(oa) | set(ob))
                problems.append(
                    f"final agent {i} stats: "
                    + "; ".join(
                        f"{k}: ours={oa.get(k)} ref={ob.get(k)}"
                        for k in keys
                        if oa.get(k) != ob.get(k)
                    )
                )
    return problems
