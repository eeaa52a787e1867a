"""Bit-exact parity tooling: the reference RNG (the host std::mt19937 that the
engine's MT19937 twin, engine/mt19937.py, is held to) and episode
signatures."""

from mettagrid_tpu_torch.parity.rng import ReferenceRng
from mettagrid_tpu_torch.parity.signature import episode_signature, state_summary

__all__ = ["ReferenceRng", "episode_signature", "state_summary"]
