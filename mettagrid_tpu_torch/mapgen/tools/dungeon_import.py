"""Import dungeon layouts as WFC/ConvChain pattern scenes
(reference: mapgen/tools/dcss_import.py).

Extracts ASCII maps from Dungeon Crawl Stone Soup ``.des`` vault files (local
path or the upstream GitHub raw URL), normalizes them to '#'/'.' wall masks,
and writes one YAML scene config per map under ``<out>/wfc/`` and
``<out>/convchain/``. The bundled library shipped with the package
(``mapgen/scenes/dungeon_patterns/``) was produced from hand-authored samples
with the same pipeline; run this tool to regenerate or extend it.

Usage:
    python -m mettagrid_tpu_torch.mapgen.tools.dungeon_import --src simple.des --out <dir>
"""

from __future__ import annotations

import argparse
import logging
import re
import urllib.request
from pathlib import Path

import yaml

logger = logging.getLogger(__name__)

DCSS_SIMPLE_DES_URL = (
    "https://raw.githubusercontent.com/crawl/crawl/master/crawl-ref/source/dat/des/arrival/simple.des"
)

_MAP_BLOCK = re.compile(r"^MAP\n(.*?)^ENDMAP", re.MULTILINE | re.DOTALL)
_NAME_LINE = re.compile(r"^NAME:\s*(\S+)", re.MULTILINE)


def normalize_map_source(ascii_source: str) -> str:
    """Pad lines to equal length; 'x' (rock wall) -> '#', everything else -> '.'."""
    lines = ascii_source.split("\n")
    width = max((len(line) for line in lines), default=0)
    out = []
    for line in lines:
        padded = line.ljust(width)
        out.append("".join("#" if ch == "x" else "." for ch in padded))
    return "\n".join(out)


def extract_maps(des_text: str) -> dict[str, str]:
    """Return {vault_name: normalized_ascii} for every MAP..ENDMAP block."""
    maps: dict[str, str] = {}
    # Vault files interleave NAME: headers and MAP blocks; pair them in order.
    names = [m.start() for m in _NAME_LINE.finditer(des_text)]
    name_values = [m.group(1) for m in _NAME_LINE.finditer(des_text)]
    for block in _MAP_BLOCK.finditer(des_text):
        preceding = [n for i, n in enumerate(name_values) if names[i] < block.start()]
        name = preceding[-1] if preceding else f"map_{block.start()}"
        normalized = normalize_map_source(block.group(1).rstrip("\n"))
        if normalized.strip("\n. "):
            maps[name] = normalized
    return maps


def is_trivial(ascii_map: str) -> bool:
    return not any(ch == "#" for ch in ascii_map)


def write_pattern_configs(maps: dict[str, str], out_dir: Path, validate_wfc: bool = True) -> None:
    from mettagrid_tpu_torch.mapgen.utils.make_scene_config import (
        make_convchain_config_from_pattern,
        make_wfc_config_from_pattern,
    )

    (out_dir / "wfc").mkdir(parents=True, exist_ok=True)
    (out_dir / "convchain").mkdir(parents=True, exist_ok=True)
    for name, pattern in maps.items():
        if is_trivial(pattern):
            logger.info("skipping trivial map %s", name)
            continue
        safe = re.sub(r"[^\w]+", "_", name)
        cc_cfg = make_convchain_config_from_pattern(pattern)
        (out_dir / "convchain" / f"{safe}.yaml").write_text(
            yaml.safe_dump(cc_cfg.model_dump(exclude_defaults=True), sort_keys=True)
        )
        if validate_wfc:
            wfc_cfg = make_wfc_config_from_pattern(pattern)
            if wfc_cfg is None:
                logger.info("WFC validation failed for %s; convchain only", name)
                continue
        else:
            from mettagrid_tpu_torch.mapgen.scenes.wfc import WFC

            wfc_cfg = WFC.Config(pattern_size=3, pattern=pattern)
        (out_dir / "wfc" / f"{safe}.yaml").write_text(
            yaml.safe_dump(wfc_cfg.model_dump(exclude_defaults=True), sort_keys=True)
        )


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--src", default=DCSS_SIMPLE_DES_URL, help="Path or URL of a .des vault file")
    parser.add_argument("--out", required=True, help="Output directory")
    parser.add_argument("--no-validate", action="store_true", help="Skip WFC probe validation")
    args = parser.parse_args()

    if re.match(r"^https?://", args.src):
        with urllib.request.urlopen(args.src) as response:
            text = response.read().decode("utf-8")
    else:
        text = Path(args.src).read_text()

    maps = extract_maps(text)
    logger.info("extracted %d maps", len(maps))
    write_pattern_configs(maps, Path(args.out), validate_wfc=not args.no_validate)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
