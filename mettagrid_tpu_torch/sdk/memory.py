"""Agent memory records, queries, and an in-memory store
(reference: sdk/agent/types.py memory protocol — the reference ships the
protocol only; the store here is a usable default implementation)."""

from __future__ import annotations

from typing import Optional, Protocol, runtime_checkable

from pydantic import BaseModel, Field

from mettagrid_tpu_torch.sdk.state import GridPosition, MettagridState


class MemoryRecord(BaseModel):
    record_id: str
    kind: str
    summary: str = ""
    tags: list[str] = Field(default_factory=list)
    game: str | None = None
    step: int | None = None
    location: GridPosition | None = None
    region_id: str | None = None
    role_context: str | None = None
    importance: float = 0.0
    source: str = ""
    evidence_ids: list[str] = Field(default_factory=list)


class EventMemoryRecord(MemoryRecord):
    kind: str = "event"
    event_type: str


class PlanMemoryRecord(MemoryRecord):
    kind: str = "plan"
    plan_type: str
    status: str = "active"


class BeliefMemoryRecord(MemoryRecord):
    kind: str = "belief"
    belief_type: str
    confidence: float = 0.0


class MemoryQuery(BaseModel):
    game: str | None = None
    step: int | None = None
    role_context: str | None = None
    target_tags: list[str] = Field(default_factory=list)
    active_plan: str | None = None
    text: str = ""

    @classmethod
    def from_state(
        cls,
        state: MettagridState,
        *,
        active_plan: str | None = None,
        extra_tags: Optional[list[str]] = None,
    ) -> "MemoryQuery":
        target_tags = set()
        if state.self_state.role is not None:
            target_tags.add(state.self_state.role)
        target_tags.update(state.self_state.status)
        for entity in state.visible_entities:
            target_tags.add(entity.entity_type)
            target_tags.update(entity.labels)
        if extra_tags:
            target_tags.update(extra_tags)
        return cls(
            game=state.game,
            step=state.step,
            role_context=state.self_state.role,
            target_tags=sorted(target_tags),
            active_plan=active_plan,
        )


class RetrievedMemoryRecord(BaseModel):
    record: MemoryRecord
    score: float
    relevance_score: float
    recency_score: float
    importance_score: float


@runtime_checkable
class MemoryView(Protocol):
    def recent_records(self, limit: int = 10) -> list[MemoryRecord]: ...

    def retrieve(self, query: MemoryQuery, limit: int = 10) -> list[RetrievedMemoryRecord]: ...

    def render_prompt_context(self, query: MemoryQuery, limit: int = 6) -> str: ...

    def read_scratchpad(self) -> str: ...

    def replace_scratchpad(self, text: str) -> None: ...

    def append_scratchpad(self, text: str) -> None: ...


class InMemoryMemoryStore:
    """Default MemoryView: tag-overlap relevance x recency x importance."""

    def __init__(self, recency_horizon: int = 512) -> None:
        self._records: list[MemoryRecord] = []
        self._scratchpad = ""
        self._kv: dict[str, object] = {}
        self._recency_horizon = recency_horizon

    # --- writes ---
    def add(self, record: MemoryRecord) -> None:
        self._records.append(record)

    # --- MemoryView ---
    def recent_records(self, limit: int = 10) -> list[MemoryRecord]:
        return list(self._records[-limit:])[::-1]

    def retrieve(self, query: MemoryQuery, limit: int = 10) -> list[RetrievedMemoryRecord]:
        out = []
        qtags = set(query.target_tags)
        words = set(query.text.lower().split())
        for rec in self._records:
            if query.game is not None and rec.game is not None and rec.game != query.game:
                continue
            rtags = set(rec.tags)
            overlap = len(qtags & rtags) / max(len(qtags | rtags), 1)
            text_hit = (
                len(words & set(rec.summary.lower().split())) / max(len(words), 1)
                if words
                else 0.0
            )
            relevance = max(overlap, text_hit)
            if query.role_context and rec.role_context == query.role_context:
                relevance = min(relevance + 0.25, 1.0)
            if query.step is not None and rec.step is not None:
                age = max(query.step - rec.step, 0)
                recency = max(1.0 - age / self._recency_horizon, 0.0)
            else:
                recency = 0.5
            importance = max(min(rec.importance, 1.0), 0.0)
            score = 0.5 * relevance + 0.3 * recency + 0.2 * importance
            out.append(
                RetrievedMemoryRecord(
                    record=rec,
                    score=score,
                    relevance_score=relevance,
                    recency_score=recency,
                    importance_score=importance,
                )
            )
        out.sort(key=lambda r: (-r.score, r.record.record_id))
        return out[:limit]

    def render_prompt_context(self, query: MemoryQuery, limit: int = 6) -> str:
        hits = self.retrieve(query, limit=limit)
        if not hits:
            return "no relevant memories"
        return "\n".join(
            f"- [{h.record.kind}] {h.record.summary or h.record.record_id}" for h in hits
        )

    def read_scratchpad(self) -> str:
        return self._scratchpad

    def replace_scratchpad(self, text: str) -> None:
        self._scratchpad = text

    def append_scratchpad(self, text: str) -> None:
        self._scratchpad = (self._scratchpad + "\n" + text) if self._scratchpad else text

    # --- mapping access ---
    def get(self, key: str, default: object = None) -> object:
        return self._kv.get(key, default)

    def __contains__(self, key: object) -> bool:
        return key in self._kv

    def __getitem__(self, key: str) -> object:
        return self._kv[key]

    def __setitem__(self, key: str, value: object) -> None:
        self._kv[key] = value
