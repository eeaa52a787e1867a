"""The territory configuration as mettagrid_tpu_torch runs it: upstream's
make_arena(24, combat=False) on its MapGen maps, with the junctions, the
territory, the AOE and the AOE-mask observations that ``territory.json``
states, rule for rule."""

from __future__ import annotations


def port_config(spec: dict, max_steps: int):
    from mettagrid_tpu_torch.builder import make_arena
    from mettagrid_tpu_torch.config.game_config import GridObjectConfig
    from mettagrid_tpu_torch.config.handler_config import (
        AOEConfig,
        EntityTarget,
        Handler,
        ResourceDeltaMutation,
        SharedTagPrefixFilter,
    )
    from mettagrid_tpu_torch.config.territory_config import TerritoryConfig, TerritoryControlConfig
    from mettagrid_tpu_torch.mapgen import MapGen
    from mettagrid_tpu_torch.mapgen.scenes import Random

    def parts(rule: dict):
        """(filters, mutations) of a rule: an optional shared-tag-prefix filter and
        resource deltas on the agent."""
        filters = [SharedTagPrefixFilter(tag_prefix=rule["shared_tag_prefix"])] if "shared_tag_prefix" in rule else []
        return filters, [ResourceDeltaMutation(target=EntityTarget.TARGET, deltas=dict(rule["deltas"]))]

    m = spec["map"]
    cfg = make_arena(spec["num_agents"], combat=False, map_builder=MapGen.Config(
        width=m["width"], height=m["height"], border_width=m["border_width"],
        instance=Random.Config(agents=m["agents"], objects=dict(m["objects"]))))
    cfg.game.agent.tags = list(spec["agent"]["tags"])
    for name, obj in spec["objects"].items():
        if name in cfg.game.objects:  # the preset's walls
            continue
        aoes = {}
        for aoe_name, rule in obj["aoes"].items():
            filters, mutations = parts(rule)
            aoes[aoe_name] = AOEConfig(name=aoe_name, radius=rule["radius"], effect_self=rule["effect_self"],
                                       filters=filters, mutations=mutations,
                                       presence_deltas=dict(rule["presence_deltas"]))
        cfg.game.objects[name] = GridObjectConfig(
            name=name, map_name=name, tags=list(obj["tags"]), aoes=aoes,
            territory_controls=[TerritoryControlConfig(**c) for c in obj["territory_controls"]])
    territories = {}
    for name, t in spec["territories"].items():
        handlers = {}
        for kind in ("on_enter", "on_exit", "presence"):
            filters, mutations = parts(t[kind])
            handlers[kind] = Handler(name=f"{name}.{kind}", filters=filters, mutations=mutations)
        territories[name] = TerritoryConfig(tag_prefix=t["tag_prefix"], **handlers)
    cfg.game.territories = territories
    cfg.game.obs.aoe_mask = spec["obs"]["aoe_mask"]
    cfg.game.protocol_details_obs = spec["obs"]["protocol_details_obs"]
    cfg.game.max_steps = max_steps
    return cfg
