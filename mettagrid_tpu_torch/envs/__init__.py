"""Framework adapters (reference: python/src/mettagrid/envs/).

The PettingZoo and PufferLib adapters are imported when first named, so
that importing the package pulls in neither optional framework."""

from mettagrid_tpu_torch.envs.grid_obs_wrapper import GridObsWrapper
from mettagrid_tpu_torch.envs.vector_env import Buffers, MettaGridVectorEnv

_LAZY = {
    "MettaGridPettingZooEnv": "mettagrid_tpu_torch.envs.pettingzoo_env",
    "MettaGridPufferEnv": "mettagrid_tpu_torch.envs.puffer_env",
}

__all__ = [
    "Buffers",
    "GridObsWrapper",
    "MettaGridPettingZooEnv",
    "MettaGridPufferEnv",
    "MettaGridVectorEnv",
]


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
