"""Scripted-agent SDK (reference: python/src/mettagrid/sdk/)."""

from mettagrid_tpu_torch.sdk.actions import (
    ActionCatalog,
    ActionDescriptor,
    ActionOutcome,
    MettagridActions,
)
from mettagrid_tpu_torch.sdk.decode import (
    DecodedObservation,
    ObservationCell,
    ObservationEnvelope,
    decode_observation,
)
from mettagrid_tpu_torch.sdk.directives import MacroDirective
from mettagrid_tpu_torch.sdk.helpers import (
    HelperCapability,
    HelperCatalog,
    MettagridHelpers,
    StateHelperCatalog,
)
from mettagrid_tpu_torch.sdk.log import ListLogSink, LogRecord, LogSink, ReviewRequest
from mettagrid_tpu_torch.sdk.memory import (
    BeliefMemoryRecord,
    EventMemoryRecord,
    InMemoryMemoryStore,
    MemoryQuery,
    MemoryRecord,
    MemoryView,
    PlanMemoryRecord,
    RetrievedMemoryRecord,
)
from mettagrid_tpu_torch.sdk.observation import build_state
from mettagrid_tpu_torch.sdk.progress import ProgressSnapshot
from mettagrid_tpu_torch.sdk.state import (
    GridPosition,
    KnownWorldState,
    MettagridState,
    SelfState,
    SemanticEntity,
    SemanticEvent,
    TeamMemberSummary,
    TeamSummary,
)
from mettagrid_tpu_torch.sdk.types import MettagridSDK, PlanView

__all__ = [
    "ActionCatalog",
    "ActionDescriptor",
    "ActionOutcome",
    "BeliefMemoryRecord",
    "DecodedObservation",
    "EventMemoryRecord",
    "GridPosition",
    "HelperCapability",
    "HelperCatalog",
    "InMemoryMemoryStore",
    "KnownWorldState",
    "ListLogSink",
    "LogRecord",
    "LogSink",
    "MacroDirective",
    "MemoryQuery",
    "MemoryRecord",
    "MemoryView",
    "MettagridActions",
    "MettagridHelpers",
    "MettagridSDK",
    "MettagridState",
    "ObservationCell",
    "ObservationEnvelope",
    "PlanMemoryRecord",
    "PlanView",
    "ProgressSnapshot",
    "RetrievedMemoryRecord",
    "SelfState",
    "SemanticEntity",
    "SemanticEvent",
    "TeamMemberSummary",
    "TeamSummary",
    "build_state",
    "decode_observation",
]
