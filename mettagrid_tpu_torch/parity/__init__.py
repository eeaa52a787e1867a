"""Parity tooling: episode signatures (the reference RNG lives in the
engine's MT19937 twin, engine/mt19937.py)."""

from mettagrid_tpu_torch.parity.signature import episode_signature, state_summary

__all__ = ["episode_signature", "state_summary"]
