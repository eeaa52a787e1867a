"""Aggregate SDK handle given to scripted agents
(reference: sdk/agent/types.py MettagridSDK)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Protocol, runtime_checkable

from mettagrid_tpu_torch.sdk.actions import MettagridActions
from mettagrid_tpu_torch.sdk.helpers import MettagridHelpers
from mettagrid_tpu_torch.sdk.log import LogSink
from mettagrid_tpu_torch.sdk.memory import MemoryView
from mettagrid_tpu_torch.sdk.progress import ProgressSnapshot
from mettagrid_tpu_torch.sdk.state import MettagridState


@runtime_checkable
class PlanView(Protocol):
    def read_plan(self, max_chars: int = 4000) -> str: ...

    def replace_plan(self, text: str) -> None: ...

    def append_plan(self, text: str) -> None: ...


@dataclass(slots=True)
class MettagridSDK:
    """Everything a scripted agent can see and do in one step."""

    state: MettagridState
    actions: MettagridActions
    helpers: MettagridHelpers
    memory: MemoryView
    log: LogSink
    plan: Optional[PlanView] = None
    progress: Optional[ProgressSnapshot] = None

    @property
    def scratchpad(self) -> str:
        return self.memory.read_scratchpad()

    def read_scratchpad(self) -> str:
        return self.memory.read_scratchpad()

    def replace_scratchpad(self, text: str) -> None:
        self.memory.replace_scratchpad(text)

    def append_scratchpad(self, text: str) -> None:
        self.memory.append_scratchpad(text)

    def read_plan(self, max_chars: int = 4000) -> str:
        return "" if self.plan is None else self.plan.read_plan(max_chars=max_chars)

    def replace_plan(self, text: str) -> None:
        if self.plan is not None:
            self.plan.replace_plan(text)

    def append_plan(self, text: str) -> None:
        if self.plan is not None:
            self.plan.append_plan(text)
