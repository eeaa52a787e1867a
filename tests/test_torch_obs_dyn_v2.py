"""Kernel B3's plain version and the port's B3 routes against the JAX engine,
exactly.

B3 is the v2 tail over a per-env image built beforehand; the port takes it
for maps whose image and tables exceed one block's shared memory. Here the
route is forced at small size by patching the obs module's shared-memory
limit (MAX_SMEM) to 0 bytes. The inputs come from a real small arena state
(E=8, A=4, after 3 random steps);
the JAX Pallas kernel ``obs_tail_dyn_v2_pallas`` runs in interpret mode (the
reference's ``_OBS_DYNOBJ=False`` leg). Map widths 10 and 40 give one and two
128-lane tiles per image row, so windows cross lane tiles. Tolerance: exact
(integer token words).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import mettagrid_tpu.engine.obs as jobs
from mettagrid_tpu.engine.pallas_kernels import obs_tail_dyn_v2_pallas
from mettagrid_tpu_torch import builder as tbuilder
from mettagrid_tpu_torch import engine as tengine
from mettagrid_tpu_torch.engine import obs as tobs
from mettagrid_tpu_torch.engine.interop import state_from_numpy
from mettagrid_tpu_torch.engine.kernels.obs_tail_dyn_v2 import obs_tail_dyn_v2, obs_tail_dyn_v2_ref
from mettagrid_tpu_torch.maps.random_map import RandomMapBuilder
from tests.test_torch_obs_tail import _arena, _jax_case, _state_numpy

E = 8


def _port(width):
    return _arena(tengine, tbuilder, RandomMapBuilder, width)


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("width", [10, 40])
def test_ref_matches_pallas_interpret(width, wide, monkeypatch):
    """The same inputs (the port's per-env image, windows, globals) through
    the Pallas kernel and the plain version, normal and wide packing."""
    program, _, state = _jax_case(width, 1)
    t = jobs.make_obs_fn(program)._tables
    assert t["v2_ok"] and (t["WPC_f"] > 128) == (width > 10)
    monkeypatch.setattr(tobs, "MAX_SMEM", 0)
    fn = tobs.make_obs_fn(_port(width)[0], None, "cpu")
    assert fn.tail is obs_tail_dyn_v2
    args = fn.tail_inputs(state_from_numpy(_state_numpy(state), "cpu"))
    assert tuple(args["imgp"].shape[1:]) == (t["HP_f"], t["WPC_f"]) and args["S"] == t["S"]
    np.testing.assert_array_equal(args["gplus"].numpy(), np.asarray(t["global_plus"](state, E)))
    loc_sh = 14 if wide else 15
    loc15 = np.asarray(t["loc15"]) >> 15 << loc_sh  # the location table for this packing
    jw, ja = obs_tail_dyn_v2_pallas(
        jnp.asarray(args["imgp"].numpy()), jnp.asarray(args["row0"].numpy()), jnp.asarray(args["lane0"].numpy()),
        jnp.asarray(args["gplus"].numpy()), t["perm2"], t["tri2"], jnp.asarray(loc15), t["KS"],
        out_w=fn.out_w, wide=wide, interpret=True,
    )
    tw, ta = obs_tail_dyn_v2_ref(**args, out_w=fn.out_w, wide=wide)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


@pytest.mark.parametrize("background", ["static", "mutable"])
@pytest.mark.parametrize("width", [10, 40])
def test_obs_fn_matches_jax_dyn_v2_and_xla(width, background, monkeypatch):
    """The port's whole B3 route, with the image assembled from the static
    pool plus the agents or built from every object, against the JAX
    engine's dyn_v2 route (XLA-assembled image, Pallas kernel in interpret
    mode). (The JAX package's own tests hold that route equal to its plain
    XLA route.)"""
    program, init, state = _jax_case(width, 1)
    jobs._FORCE_FUSED_INTERPRET = True
    old = jobs._OBS_DYNOBJ
    jobs._OBS_DYNOBJ = False
    try:
        fused_obs, fused_att = jobs.make_obs_fn(program)(state)
        assert jobs._LAST_TAIL == "dyn_v2"
    finally:
        jobs._FORCE_FUSED_INTERPRET = False
        jobs._OBS_DYNOBJ = old
    tp, ti = _port(width)
    bg = tobs.build_static_bg(tp, ti, "cpu") if background == "static" else None
    monkeypatch.setattr(tobs, "MAX_SMEM", 0)
    fn = tobs.make_obs_fn(tp, bg, "cpu")
    assert fn.tail is obs_tail_dyn_v2 and fn.route == "B3"
    before = obs_tail_dyn_v2.launches
    obs, att = fn(state_from_numpy(_state_numpy(state), "cpu"))
    assert obs_tail_dyn_v2.launches == before  # CPU tensors take the plain version
    np.testing.assert_array_equal(obs.numpy(), np.asarray(fused_obs))
    np.testing.assert_array_equal(att.numpy(), np.asarray(fused_att))
