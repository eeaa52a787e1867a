"""Scene implementations (reference: python/src/mettagrid/mapgen/scenes/)."""

from mettagrid_tpu_torch.mapgen.scenes.biomes import (
    BiomeCaves,
    BiomeCity,
    BiomeDesert,
    BiomeForest,
    BiomePlains,
)
from mettagrid_tpu_torch.mapgen.scenes.auto import Auto, AutoLayout, AutoSymmetry
from mettagrid_tpu_torch.mapgen.scenes.bsp import BSP, BSPLayout
from mettagrid_tpu_torch.mapgen.scenes.building_distributions import (
    DistributionConfig,
    DistributionType,
    UniformExtractorScene,
)
from mettagrid_tpu_torch.mapgen.scenes.compound import Compound, FourCornerCompounds
from mettagrid_tpu_torch.mapgen.scenes.grid_hubs import GridHubs
from mettagrid_tpu_torch.mapgen.scenes.multi_left_and_right import MultiLeftAndRight
from mettagrid_tpu_torch.mapgen.scenes.varied_terrain import VariedTerrain
from mettagrid_tpu_torch.mapgen.scenes.convchain import ConvChain
from mettagrid_tpu_torch.mapgen.scenes.inline_ascii import InlineAscii
from mettagrid_tpu_torch.mapgen.scenes.layout import Layout
from mettagrid_tpu_torch.mapgen.scenes.make_connected import MakeConnected
from mettagrid_tpu_torch.mapgen.scenes.maze import Maze, MazeKruskal
from mettagrid_tpu_torch.mapgen.scenes.mirror import Mirror
from mettagrid_tpu_torch.mapgen.scenes.file_scenes import (
    Ascii,
    RandomDungeonScene,
    RandomYamlScene,
    YamlScene,
)
from mettagrid_tpu_torch.mapgen.scenes.misc import (
    AsteroidMask,
    BoundedLayout,
    CopyGrid,
    Dither,
    MeanDistance,
    RadialMaze,
    RandomObjects,
    RemoveAgents,
    Spiral,
)
from mettagrid_tpu_torch.mapgen.scenes.transplant import TransplantScene
from mettagrid_tpu_torch.mapgen.scenes.nop import Nop
from mettagrid_tpu_torch.mapgen.scenes.random import Random
from mettagrid_tpu_torch.mapgen.scenes.random_scene import RandomScene
from mettagrid_tpu_torch.mapgen.scenes.room_grid import RoomGrid
from mettagrid_tpu_torch.mapgen.scenes.wfc import WFC

__all__ = [
    "Ascii",
    "AsteroidMask",
    "Auto",
    "AutoLayout",
    "AutoSymmetry",
    "Compound",
    "DistributionConfig",
    "DistributionType",
    "FourCornerCompounds",
    "GridHubs",
    "MultiLeftAndRight",
    "UniformExtractorScene",
    "VariedTerrain",
    "BSP",
    "BSPLayout",
    "BoundedLayout",
    "MeanDistance",
    "RandomDungeonScene",
    "RandomYamlScene",
    "TransplantScene",
    "YamlScene",
    "BiomeCaves",
    "BiomeCity",
    "BiomeDesert",
    "BiomeForest",
    "BiomePlains",
    "ConvChain",
    "CopyGrid",
    "Dither",
    "InlineAscii",
    "Layout",
    "MakeConnected",
    "Maze",
    "MazeKruskal",
    "Mirror",
    "Nop",
    "RadialMaze",
    "Random",
    "RandomObjects",
    "RandomScene",
    "RemoveAgents",
    "RoomGrid",
    "Spiral",
    "WFC",
]
