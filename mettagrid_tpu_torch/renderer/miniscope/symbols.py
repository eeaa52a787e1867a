"""Symbol maps for the miniscope TUI
(reference: renderer/miniscope/symbol.py)."""

AGENT_SYMBOLS = ["🤖", "🦾", "🤠", "👽", "🧑", "🧛", "🧟", "🥷", "🧙", "🦸"]

DEFAULT_SYMBOL_MAP = {
    "wall": "⬛",
    "empty": "· ",
    "block": "📦",
    "agent": "🤖",
    "mine": "⛏️ ",
    "generator": "⚡",
    "altar": "🛐",
    "chest": "🧰",
    "hub": "🏠",
    "junction": "🔗",
    "carbon_extractor": "⚫",
    "oxygen_extractor": "🟦",
    "germanium_extractor": "🟣",
    "silicon_extractor": "🔷",
    "cursor": "🎯",
    "unknown": "❓",
}


def symbol_for(symbol_map: dict, type_name: str, agent_id=None) -> str:
    if agent_id is not None:
        return AGENT_SYMBOLS[agent_id % len(AGENT_SYMBOLS)]
    if type_name in symbol_map:
        return symbol_map[type_name]
    base = type_name.split(".")[0]
    return symbol_map.get(base, DEFAULT_SYMBOL_MAP["unknown"])
