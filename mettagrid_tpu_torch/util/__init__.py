"""Host utilities (reference: mettagrid_tpu/util/): URI file IO
(``file``), episode stats sinks (``stats_writer``), and the modules whose
names this package exports."""

from mettagrid_tpu_torch.util.dict_utils import unroll_nested_dict
from mettagrid_tpu_torch.util.diversity import calculate_diversity_bonus
from mettagrid_tpu_torch.util.module import load_symbol
from mettagrid_tpu_torch.util.tracer import NullTracer, Tracer
from mettagrid_tpu_torch.util.uri_resolvers import (
    CheckpointMetadata,
    checkpoint_metadata,
    parse_uri,
    resolve_latest_checkpoint,
)

__all__ = [
    "CheckpointMetadata",
    "NullTracer",
    "Tracer",
    "calculate_diversity_bonus",
    "checkpoint_metadata",
    "load_symbol",
    "parse_uri",
    "resolve_latest_checkpoint",
    "unroll_nested_dict",
]
