"""Replay-v4 schema validator — a Python twin of the mettascope loader's
validation pass (reference: nim/mettascope/src/mettascope/validation.nim,
entry proc validateReplay; version pin at nim/mettascope/src/mettascope/
replays.nim:7 `FormatVersion* = 4`).

This is the interop proof for repo-written replays: every check the
reference GUI's loader applies before accepting a replay file is encoded
here, so `validate_replay(data) == []` means the mettascope viewer would
load the file without validation issues. Checks mirror validation.nim
proc-for-proc (requireFields, validateTimeSeries, validateInventoryFormat,
validateLocation, validateAgentFields, validateHubFields,
validateBuildingFields, validateObject, validateReplaySchema); issue
messages are paraphrased, semantics are kept exact — including quirks like
"time series must start with step 0" and the agent-count equality.

JSON-type note: Nim's json distinguishes JBool from JInt; Python's bool is
an int subclass, so every integer check here explicitly excludes bool.
"""

from __future__ import annotations

from typing import Any, List

# validation.nim:13-19
REQUIRED_KEYS = (
    "version",
    "num_agents",
    "max_steps",
    "map_size",
    "action_names",
    "item_names",
    "type_names",
    "objects",
)
OPTIONAL_KEYS = (
    "file_name",
    "group_names",
    "capacity_names",
    "animation_names",
    "reward_sharing_matrix",
    "mg_config",
    "policy_env_interface",
    "infos",
    "tags",
)

FORMAT_VERSION = 4  # replays.nim:7


def _is_int(v: Any) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


def _is_number(v: Any) -> bool:
    return (isinstance(v, (int, float))) and not isinstance(v, bool)


def _json_type(v: Any) -> str:
    if isinstance(v, bool):
        return "bool"
    if isinstance(v, int):
        return "int"
    if isinstance(v, float):
        return "float"
    if isinstance(v, str):
        return "string"
    if isinstance(v, (list, tuple)):
        return "array"
    if isinstance(v, dict):
        return "object"
    if v is None:
        return "null"
    return type(v).__name__


def _type_ok(v: Any, expected: str) -> bool:
    return _json_type(v) == expected


class _Issues(list):
    def add(self, message: str, field: str = "") -> None:
        self.append(f"{message}" + (f" (field: {field})" if field else ""))


def _require_fields(obj: dict, fields, obj_name: str, issues: _Issues) -> None:
    missing = [f for f in fields if f not in obj]
    if missing:
        issues.add(f"{obj_name} missing required fields: {', '.join(missing)}", obj_name)


def _validate_type(obj: dict, key: str, expected: str, field: str, issues: _Issues) -> None:
    if key not in obj:
        issues.add(f"'{field}' is missing (required)", field)
        return
    actual = _json_type(obj[key])
    if actual != expected:
        issues.add(f"'{field}' must be {expected}, got {actual}", field)


def _validate_type_value(v: Any, expected: str, field: str, issues: _Issues) -> None:
    actual = _json_type(v)
    if actual != expected:
        issues.add(f"'{field}' must be {expected}, got {actual}", field)


def _validate_positive_int_value(v: Any, field: str, issues: _Issues) -> None:
    _validate_type_value(v, "int", field, issues)
    if _is_int(v) and v <= 0:
        issues.add(f"'{field}' must be positive, got {v}", field)


def _validate_positive_int(obj: dict, key: str, field: str, issues: _Issues) -> None:
    if key not in obj:
        issues.add(f"'{field}' is missing (required)", field)
        return
    _validate_positive_int_value(obj[key], field, issues)


def _validate_non_negative_number(obj: dict, key: str, field: str, issues: _Issues) -> None:
    if key not in obj:
        issues.add(f"'{field}' is missing (required)", field)
        return
    v = obj[key]
    if _is_number(v):
        if v < 0:
            issues.add(f"'{field}' must be non-negative, got {v}", field)
    else:
        issues.add(f"'{field}' must be a number, got {_json_type(v)}", field)


def _validate_string_list(
    obj: dict, key: str, field: str, issues: _Issues, allow_empty_strings: bool = False
) -> None:
    if key not in obj:
        issues.add(f"'{field}' is missing (required)", field)
        return
    lst = obj[key]
    _validate_type_value(lst, "array", field, issues)
    if isinstance(lst, (list, tuple)):
        if len(lst) == 0:
            issues.add(f"'{field}' must not be empty", field)
        bad = []
        for i, v in enumerate(lst):
            if not isinstance(v, str):
                bad.append(f"index {i}: expected string, got {_json_type(v)}")
            elif not allow_empty_strings and len(v) == 0:
                bad.append(f"index {i}: empty string")
        if bad:
            req = "strings" if allow_empty_strings else "non-empty strings"
            issues.add(f"'{field}' must contain {req}; invalid entries: {', '.join(bad)}", field)


def _validate_static_value(obj: dict, key: str, expected: str, field: str, issues: _Issues) -> None:
    if key not in obj:
        issues.add(f"'{field}' is missing (required)", field)
        return
    if isinstance(obj[key], (list, tuple)):
        issues.add(f"'{field}' must be a single value, not an array", field)
        return
    _validate_type(obj, key, expected, field, issues)


def _scalar_matches(v: Any, expected: str) -> bool:
    # validation.nim:201-212 — a "float" time series accepts a bare int.
    if expected == "int":
        return _is_int(v)
    if expected == "float":
        return _is_number(v)
    if expected == "bool":
        return isinstance(v, bool)
    return False


def _validate_time_series(obj: dict, key: str, field: str, expected: str, issues: _Issues) -> None:
    if key not in obj:
        issues.add(f"'{field}' is missing (required)", field)
        return
    data = obj[key]
    if _scalar_matches(data, expected):
        return
    if isinstance(data, (list, tuple)):
        if len(data) == 0:
            return
        for item in data:
            if not isinstance(item, (list, tuple)) or len(item) != 2:
                issues.add(f"'{field}' time series items must be [step, value] pairs", field)
                return
            step, value = item
            if not _is_int(step) or step < 0:
                issues.add(f"'{field}' time series step must be non-negative", field)
            if expected == "int" and not _is_int(value):
                issues.add(f"'{field}' time series value must be int", field)
            elif expected == "float" and not _is_number(value):
                issues.add(f"'{field}' time series value must be number", field)
            elif expected == "bool" and not isinstance(value, bool):
                issues.add(f"'{field}' time series value must be bool", field)
        if len(data) > 0 and _is_int(data[0][0]) and data[0][0] != 0:
            issues.add(f"'{field}' time series must start with step 0", field)
        return
    issues.add(f"'{field}' must be {expected} or time series of [step, {expected}] pairs", field)


def _validate_inventory_format(obj: dict, key: str, field: str, issues: _Issues) -> None:
    """validation.nim:272-403 — [itemId, count] pairs or time series of
    [step, [[itemId, count], ...]]."""
    if key not in obj:
        issues.add(f"'{field}' is missing (required)", field)
        return
    inv = obj[key]
    if inv is None:
        return
    _validate_type_value(inv, "array", field, issues)
    if not isinstance(inv, (list, tuple)) or len(inv) == 0:
        return

    is_pairs = True
    ts_count = 0
    static_count = 0
    for item in inv:
        if isinstance(item, (list, tuple)) and len(item) == 2:
            first, second = item
            if _is_int(first) and first >= 0:
                if isinstance(second, (list, tuple)):
                    ts_count += 1
                elif _is_int(second) and second >= 0:
                    static_count += 1
                else:
                    is_pairs = False
                    break
            else:
                is_pairs = False
                break
        else:
            is_pairs = False
            break

    if not is_pairs or (ts_count > 0 and static_count > 0):
        if ts_count > 0 and static_count > 0:
            issues.add(
                f"'{field}' has mixed time series and static inventory formats"
                " - all items must be the same format",
                field,
            )
        elif not is_pairs:
            issues.add(
                f"'{field}' items must be [step, inventory_array] for time series"
                " or [itemId, count] for static",
                field,
            )

    if is_pairs and ts_count > 0 and static_count == 0:
        for step, ts_inv in inv:
            if not _is_int(step) or step < 0:
                issues.add(f"'{field}' time series step must be non-negative integer", field)
            if not isinstance(ts_inv, (list, tuple)):
                issues.add(f"'{field}' time series value must be array of item amounts", field)
                continue
            for amount in ts_inv:
                if not isinstance(amount, (list, tuple)) or len(amount) != 2:
                    issues.add(f"'{field}' item amounts must be [itemId, count] pairs", field)
                    continue
                item_id, count = amount
                if not _is_int(item_id) or item_id < 0:
                    issues.add(f"'{field}' item IDs must be non-negative integers", field)
                if not _is_int(count) or count < 0:
                    issues.add(f"'{field}' item counts must be non-negative integers", field)
        return

    for amount in inv:
        if not isinstance(amount, (list, tuple)) or len(amount) != 2:
            issues.add(f"'{field}' static inventory must be array of [itemId, count] pairs", field)
            continue
        item_id, count = amount
        if not _is_int(item_id) or item_id < 0:
            issues.add(f"'{field}' item IDs must be non-negative integers", field)
        if not _is_int(count) or count < 0:
            issues.add(f"'{field}' item counts must be non-negative integers", field)


def _validate_location(obj: dict, key: str, field: str, issues: _Issues) -> None:
    """validation.nim:405-476 — single [x, y(, z)] or time series of
    [step, [x, y]] pairs starting at step 0."""
    if key not in obj:
        issues.add(f"'{field}' is missing (required)", field)
        return
    loc = obj[key]
    if isinstance(loc, (list, tuple)) and len(loc) in (2, 3) and all(_is_number(c) for c in loc):
        return
    _validate_type_value(loc, "array", field, issues)
    if isinstance(loc, (list, tuple)) and len(loc) == 0:
        issues.add(f"{field} must have at least one entry", field)
    if isinstance(loc, (list, tuple)):
        for step_data in loc:
            if not isinstance(step_data, (list, tuple)) or len(step_data) != 2:
                issues.add(f"{field} items must be [step, [x, y]] pairs", field)
                continue
            step, coords = step_data
            if not _is_int(step) or step < 0:
                issues.add(f"{field} step must be non-negative", field)
            if not isinstance(coords, (list, tuple)) or len(coords) not in (2, 3):
                issues.add(f"{field} coordinates must be [x, y] array", field)
                continue
            for i, c in enumerate(coords):
                if not _is_number(c):
                    issues.add(f"{field} coord[{i}] must be a number", field)
        if (
            len(loc) > 0
            and isinstance(loc[0], (list, tuple))
            and len(loc[0]) >= 1
            and _is_int(loc[0][0])
            and loc[0][0] != 0
        ):
            issues.add(f"{field} must start with step 0", field)


def _validate_action_id_range(
    obj: dict, key: str, obj_name: str, action_names: list, issues: _Issues
) -> None:
    if key not in obj:
        issues.add(f"'{obj_name}.{key}' is missing (required)", f"{obj_name}.{key}")
        return
    ids = obj[key]
    if _is_int(ids):
        if ids < 0 or ids >= len(action_names):
            issues.add(f"{obj_name}.action_id {ids} out of range", f"{obj_name}.action_id")
        return
    if isinstance(ids, (list, tuple)):
        for step_data in ids:
            if isinstance(step_data, (list, tuple)) and len(step_data) == 2:
                aid = step_data[1]
                if _is_int(aid) and (aid < 0 or aid >= len(action_names)):
                    issues.add(f"{obj_name}.action_id {aid} out of range", f"{obj_name}.action_id")


def _validate_agent_fields(obj: dict, obj_name: str, data: dict, issues: _Issues) -> None:
    """validation.nim:509-559."""
    _require_fields(
        obj,
        ("agent_id", "action_id", "action_success", "total_reward", "current_reward", "group_id"),
        obj_name,
        issues,
    )
    _validate_static_value(obj, "agent_id", "int", f"{obj_name}.agent_id", issues)
    _validate_non_negative_number(obj, "agent_id", f"{obj_name}.agent_id", issues)
    if "num_agents" in data and _is_int(obj.get("agent_id")) and _is_int(data["num_agents"]):
        if obj["agent_id"] >= data["num_agents"]:
            issues.add(
                f"{obj_name}.agent_id {obj['agent_id']} out of range", f"{obj_name}.agent_id"
            )
    _validate_static_value(obj, "group_id", "int", f"{obj_name}.group_id", issues)
    _validate_non_negative_number(obj, "group_id", f"{obj_name}.group_id", issues)

    _validate_time_series(obj, "action_id", f"{obj_name}.action_id", "int", issues)
    _validate_time_series(obj, "action_success", f"{obj_name}.action_success", "bool", issues)
    if "animation_id" in obj:
        _validate_time_series(obj, "animation_id", f"{obj_name}.animation_id", "int", issues)
    _validate_time_series(obj, "current_reward", f"{obj_name}.current_reward", "float", issues)
    _validate_time_series(obj, "total_reward", f"{obj_name}.total_reward", "float", issues)
    for opt_int in ("action_param", "action_parameter", "frozen_progress", "frozen_time"):
        if opt_int in obj:
            _validate_time_series(obj, opt_int, f"{obj_name}.{opt_int}", "int", issues)
    for opt_bool in ("frozen", "is_frozen"):
        if opt_bool in obj:
            _validate_time_series(obj, opt_bool, f"{obj_name}.{opt_bool}", "bool", issues)
    if "action_names" in data and isinstance(data["action_names"], (list, tuple)):
        _validate_action_id_range(obj, "action_id", obj_name, list(data["action_names"]), issues)


def _validate_protocol(protocol: Any, idx: int, obj_name: str, issues: _Issues) -> None:
    """validation.nim:561-635."""
    name = f"{obj_name}.protocols[{idx}]"
    _validate_type_value(protocol, "object", name, issues)
    if not isinstance(protocol, dict):
        return
    _require_fields(protocol, ("minAgents", "vibes", "inputs", "outputs", "cooldown"), name, issues)
    _validate_type(protocol, "minAgents", "int", f"{name}.minAgents", issues)
    _validate_type(protocol, "vibes", "array", f"{name}.vibes", issues)
    _validate_type(protocol, "inputs", "array", f"{name}.inputs", issues)
    _validate_type(protocol, "outputs", "array", f"{name}.outputs", issues)
    _validate_type(protocol, "cooldown", "int", f"{name}.cooldown", issues)
    if _is_int(protocol.get("minAgents")) and protocol["minAgents"] < 0:
        issues.add(f"{name}.minAgents must be non-negative", f"{name}.minAgents")
    if _is_int(protocol.get("cooldown")) and protocol["cooldown"] < 0:
        issues.add(f"{name}.cooldown must be non-negative", f"{name}.cooldown")
    if isinstance(protocol.get("vibes"), (list, tuple)):
        for i, vibe in enumerate(protocol["vibes"]):
            _validate_type_value(vibe, "int", f"{name}.vibes[{i}]", issues)
    for side in ("inputs", "outputs"):
        if isinstance(protocol.get(side), (list, tuple)):
            for i, amount in enumerate(protocol[side]):
                if isinstance(amount, (list, tuple)) and len(amount) == 2:
                    item_id, count = amount
                    _validate_type_value(item_id, "int", f"{name}.{side}[{i}][0]", issues)
                    _validate_type_value(count, "int", f"{name}.{side}[{i}][1]", issues)
                    if _is_int(count) and count < 0:
                        issues.add(
                            f"{name}.{side}[{i}][1] must be non-negative",
                            f"{name}.{side}[{i}][1]",
                        )
                else:
                    issues.add(
                        f"{name}.{side}[{i}] must be [item_id, count] array", f"{name}.{side}[{i}]"
                    )


def _validate_hub_fields(obj: dict, obj_name: str, issues: _Issues) -> None:
    """validation.nim:637-663."""
    _require_fields(
        obj, ("protocols", "uses_count", "max_uses", "allow_partial_usage"), obj_name, issues
    )
    _validate_static_value(obj, "max_uses", "int", f"{obj_name}.max_uses", issues)
    _validate_non_negative_number(obj, "max_uses", f"{obj_name}.max_uses", issues)
    _validate_static_value(
        obj, "allow_partial_usage", "bool", f"{obj_name}.allow_partial_usage", issues
    )
    _validate_type(obj, "protocols", "array", f"{obj_name}.protocols", issues)
    if isinstance(obj.get("protocols"), (list, tuple)):
        for i, protocol in enumerate(obj["protocols"]):
            if isinstance(protocol, dict):
                _validate_protocol(protocol, i, obj_name, issues)
    _validate_time_series(obj, "uses_count", f"{obj_name}.uses_count", "int", issues)


def _validate_building_fields(obj: dict, obj_name: str, issues: _Issues) -> None:
    """validation.nim:665-677."""
    _require_fields(
        obj,
        ("input_resources", "output_resources", "conversion_remaining", "is_converting"),
        obj_name,
        issues,
    )
    _validate_inventory_format(obj, "input_resources", f"{obj_name}.input_resources", issues)
    _validate_inventory_format(obj, "output_resources", f"{obj_name}.output_resources", issues)
    _validate_time_series(
        obj, "conversion_remaining", f"{obj_name}.conversion_remaining", "float", issues
    )
    _validate_time_series(obj, "is_converting", f"{obj_name}.is_converting", "bool", issues)


def _is_agent_obj(obj: dict) -> bool:
    return bool(obj.get("is_agent")) or "agent_id" in obj


def _validate_object(obj: dict, idx: int, data: dict, issues: _Issues) -> None:
    """validation.nim:679-739."""
    obj_name = f"Object {idx}"
    _require_fields(
        obj, ("id", "location", "orientation", "inventory", "inventory_max", "color"), obj_name, issues
    )
    _validate_static_value(obj, "id", "int", f"{obj_name}.id", issues)
    _validate_positive_int(obj, "id", f"{obj_name}.id", issues)

    if "type_name" not in obj and "type_id" not in obj:
        issues.add(
            f"{obj_name} must have either 'type_name' or 'type_id'", f"{obj_name}.type_name"
        )
    elif "type_name" in obj:
        _validate_static_value(obj, "type_name", "string", f"{obj_name}.type_name", issues)
        if "type_names" in data and isinstance(obj["type_name"], str):
            if obj["type_name"] not in list(data["type_names"]):
                issues.add(
                    f"{obj_name}.type_name '{obj['type_name']}' not in type_names list",
                    f"{obj_name}.type_name",
                )
    else:
        _validate_static_value(obj, "type_id", "int", f"{obj_name}.type_id", issues)
        if "type_names" in data and _is_int(obj.get("type_id")):
            n = len(list(data["type_names"]))
            if obj["type_id"] < 0 or obj["type_id"] >= n:
                issues.add(
                    f"{obj_name}.type_id {obj['type_id']} out of range (0..{n - 1})",
                    f"{obj_name}.type_id",
                )

    _validate_location(obj, "location", f"{obj_name}.location", issues)
    _validate_time_series(obj, "orientation", f"{obj_name}.orientation", "int", issues)
    _validate_inventory_format(obj, "inventory", f"{obj_name}.inventory", issues)
    _validate_time_series(obj, "inventory_max", f"{obj_name}.inventory_max", "int", issues)
    _validate_time_series(obj, "color", f"{obj_name}.color", "int", issues)
    if "alive" in obj:
        _validate_time_series(obj, "alive", f"{obj_name}.alive", "bool", issues)

    if _is_agent_obj(obj):
        _validate_agent_fields(obj, obj_name, data, issues)
    elif "protocols" in obj:
        _validate_hub_fields(obj, obj_name, issues)
    elif "input_resources" in obj:
        _validate_building_fields(obj, obj_name, issues)


def validate_replay(data: dict) -> List[str]:
    """The mettascope loader's acceptance check (validation.nim:741-872
    validateReplaySchema / validateReplay). Returns a list of issue strings;
    an empty list means the reference viewer accepts the replay."""
    issues = _Issues()
    if not isinstance(data, dict):
        return [f"replay must be a JSON object, got {_json_type(data)}"]

    keys = list(data.keys())
    missing = [k for k in REQUIRED_KEYS if k not in keys]
    allowed = set(REQUIRED_KEYS) | set(OPTIONAL_KEYS)
    unexpected = [k for k in keys if k not in allowed]
    if missing:
        issues.add(f"Missing required keys: {', '.join(missing)}")
    if unexpected:
        issues.add(f"Unexpected keys present: {', '.join(unexpected)}")

    if "version" in data:
        if data["version"] != FORMAT_VERSION:
            issues.add(f"'version' must be {FORMAT_VERSION}, got {data['version']}", "version")

    _validate_non_negative_number(data, "num_agents", "num_agents", issues)
    _validate_non_negative_number(data, "max_steps", "max_steps", issues)

    if "map_size" in data:
        ms = data["map_size"]
        _validate_type_value(ms, "array", "map_size", issues)
        if isinstance(ms, (list, tuple)):
            if len(ms) != 2:
                issues.add("'map_size' must have exactly 2 dimensions", "map_size")
            for i, v in enumerate(ms):
                _validate_positive_int_value(v, f"map_size[{i}]", issues)

    for field in ("action_names", "item_names", "type_names"):
        _validate_string_list(data, field, field, issues, allow_empty_strings=True)

    if "file_name" in data:
        _validate_type(data, "file_name", "string", "file_name", issues)
        if isinstance(data["file_name"], str) and len(data["file_name"]) == 0:
            issues.add("'file_name' must be non-empty", "file_name")

    if "group_names" in data:
        _validate_string_list(data, "group_names", "group_names", issues, allow_empty_strings=True)

    if "reward_sharing_matrix" in data and "num_agents" in data:
        matrix = data["reward_sharing_matrix"]
        _validate_type_value(matrix, "array", "reward_sharing_matrix", issues)
        if isinstance(matrix, (list, tuple)) and _is_int(data["num_agents"]):
            n = data["num_agents"]
            if len(matrix) != n:
                issues.add(f"'reward_sharing_matrix' must have {n} rows", "reward_sharing_matrix")
            for i, row in enumerate(matrix):
                _validate_type_value(row, "array", f"reward_sharing_matrix[{i}]", issues)
                if isinstance(row, (list, tuple)):
                    if len(row) != n:
                        issues.add(
                            f"'reward_sharing_matrix[{i}]' must have {n} columns",
                            f"reward_sharing_matrix[{i}]",
                        )
                    for v in row:
                        if not _is_number(v):
                            issues.add(
                                f"'reward_sharing_matrix[{i}]' must contain numbers",
                                f"reward_sharing_matrix[{i}]",
                            )

    agent_count = 0
    if "objects" in data:
        objs = data["objects"]
        _validate_type_value(objs, "array", "objects", issues)
        if isinstance(objs, (list, tuple)):
            for obj in objs:
                if not isinstance(obj, dict):
                    issues.add("'objects' must contain objects", "objects")
            for i, obj in enumerate(objs):
                if isinstance(obj, dict):
                    _validate_object(obj, i, data, issues)
                    if _is_agent_obj(obj):
                        agent_count += 1

    if "num_agents" in data and _is_int(data["num_agents"]):
        if agent_count != data["num_agents"]:
            issues.add(f"Expected {data['num_agents']} agents, found {agent_count}", "objects")

    return list(issues)
