"""Test support toolkit (reference: mettagrid_tpu/test_support/)."""

from mettagrid_tpu_torch.test_support.actions import move, noop, use
from mettagrid_tpu_torch.test_support.map_builders import ObjectNameMapBuilder
from mettagrid_tpu_torch.test_support.observation_helper import ObservationHelper

__all__ = ["ObjectNameMapBuilder", "ObservationHelper", "move", "noop", "use"]
