"""The tithe arena family (an order_by=random query in a shrine's on_use
filter, so every bump-use draws from the MT19937 stream inside an action
handler): the port's run_arena_ours at its 300 steps against the JAX
package on the CPU, the check of tests/test_torch_arena_parity.py, in a file
of its own because its sequential action phase makes it the slowest of the
families on both sides.
"""

from tests.test_torch_arena_parity import check_family


def test_tithe_matches_jax():
    check_family("tithe")
