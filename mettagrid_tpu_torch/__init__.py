"""mettagrid_tpu_torch — the PyTorch/CUDA port of the mettagrid_tpu engine.

A second package beside ``mettagrid_tpu`` (the JAX reference). Its host-side
compiler (``config``, ``maps``, ``mapgen``, ``builder`` and the numpy
modules of ``engine``) is a copy of the reference's; the device engine (state, reset,
step, observations) is rewritten in PyTorch, and each Pallas TPU kernel on
its path is a CUDA kernel written by hand for Hopper (``engine/csrc``).
The policies (``policy``) are ``torch.nn`` twins of the reference's flax
nets, and their parameters move to and from flax trees.

The package imports torch, numpy and pydantic, never jax and nothing of
``mettagrid_tpu``. Entry points run on the CUDA device unless the caller
passes ``device="cpu"``, where each kernel wrapper takes its plain PyTorch
version.
"""

from mettagrid_tpu_torch.config.game_config import GameConfig, MettaGridConfig

__all__ = ["GameConfig", "MettaGridConfig"]

__version__ = "0.1.0"
