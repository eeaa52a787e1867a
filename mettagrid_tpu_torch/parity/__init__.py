"""Bit-exact parity tooling: the reference RNG (the host std::mt19937 that the
engine's MT19937 twin, engine/mt19937.py, is held to), episode signatures,
and the runs that hold this engine to the reference C++ engine: the
cross-engine scenarios (cross_engine.py), the arena families (arena.py) and
the oracle's loader (reference_oracle.py). Their halves on this
engine run without the oracle."""

from mettagrid_tpu_torch.parity.arena import arena_map, our_config, ref_config, run_arena_ours, run_arena_parity
from mettagrid_tpu_torch.parity.cross_engine import Scenario, diff_traces, run_ours, run_reference
from mettagrid_tpu_torch.parity.reference_oracle import load_reference, reference_available, reference_state_summary
from mettagrid_tpu_torch.parity.rng import ReferenceRng
from mettagrid_tpu_torch.parity.signature import episode_signature, state_summary

__all__ = [
    "ReferenceRng",
    "Scenario",
    "arena_map",
    "diff_traces",
    "episode_signature",
    "load_reference",
    "our_config",
    "ref_config",
    "reference_available",
    "reference_state_summary",
    "run_arena_ours",
    "run_arena_parity",
    "run_ours",
    "run_reference",
    "state_summary",
]
