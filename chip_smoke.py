#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and the CUDA
toolkit. It builds the port's kernels from the sources in the checkout, then:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles every kernel with nvcc (sm_90a), all at once, and prints
   the seconds;
3. kernel vs plain: drives the flagship arena (make_arena(24, combat=False),
   a pool of 64 maps, 4096 envs) for 16 steps, feeds kernel B1 the inputs of
   the live state, and holds its words and attempted counts equal to the
   plain PyTorch version on the card, for normal and wide packing; times both
   with CUDA events (a kernel's time with its launches queued behind a spin
   kernel, so that the card runs them back to back and the time is the
   card's, beside its wrapper's time per call issued back to back, which is
   the host's rate where the host is the slower);
4. main path: resets and steps the flagship with auto-reset, carrying the
   observation buffer (8 warm-up, 64 timed steps); checks that B1 launched
   once per observation pass and no other tail kernel launched, that no
   output is NaN and that every agent attempted tokens; prints env-steps/s;
5. GPU against CPU: 48 steps of a small arena (64 envs, max_steps 24, a
   pool of one map and one of three, agent orders and reset maps fed from
   numpy) on the card and on the CPU plain path; every output and every
   state field but rng must be byte-equal;
6. B2 vs plain: drives the general bench config (combat handlers plus the
   wall_bloom event, 4096 envs, pool 64) for 24 steps, so the event has
   fired at steps 4 and 20, and holds kernel B2 equal to its plain version
   on the live state, normal and wide packing; times both;
7. general main path: 8 warm-up and 32 timed steps with random primary and
   vibe actions; checks B2's launches, that the event gave walls hearts and
   that the melee handler applied; prints env-steps/s;
8. combat main path: the same for the combat config, whose static
   background takes B1 with wide packing; checks B1's launches and that
   attacks lowered hearts; then holds B1 equal to its plain version on the
   path's last state (both packings) and times it in wide packing;
9. GPU against CPU on the general config: 64 envs, max_steps 24, a pool of
   three maps, agent orders, reset maps and event ranks from numpy, 48
   steps, for the bench config and with the combat config's starting
   inventory (so attacks deal damage); every output and every state field
   but rng must be byte-equal;
10. arena_lp (the flagship with local-position tokens, absent on the spawn
    cell): kernel B4 against its plain version on the live state after 12
    steps, timed, with its launch plan, then the main path (8 warm-up, 32
    timed steps) with B4's launches counted from 0;
11. general_lp (the general config with local-position tokens): the same
    for kernel B5 over the per-env image built from every object;
12. arena_128 (the flagship on 128x128 maps, whose image is too large to
    stage in shared memory): the same for kernel B3 over the per-env image
    in device memory (normal and wide packing), with the peak device
    memory of the main path;
13. GPU against CPU for the three new routes: 48 steps of arena_lp and
    general_lp (64 envs, max_steps 24, pool 3) and 40 steps of arena_128
    (8 envs, max_steps 16, pool 2), every output and every state field but
    rng byte-equal;
14. territory (the flagship with junctions of two teams that control
    territory and emit AOEs, and the AOE mask in the observations: the
    non-fused observation path): kernels B7 (window slices) and B8 (row
    compaction) against their plain versions on the live state after 12
    steps at full width, word for word, timed by CUDA events;
15. the territory main path (8 warm-up, 32 timed steps) from the counts at
    0: B7 and B8 launched once per observation pass and no tail kernel
    launched; friendly and enemy AOE mask tokens appear, the agents gained
    hearts; prints env-steps/s and the peak device memory;
16. GPU against CPU on the territory variant (64 envs, max_steps 24, pools
    of one map and of three, 48 steps) and on the armed combat config with
    a 15x15 window and token values in base 4 (9 token slots per cell, so
    window rows of 135 lanes: the non-fused path without the mask; 64 envs,
    max_steps 16, pool 3, 24 steps), every output and every state field but
    rng byte-equal;
17. flagship_v3 (the flagship with obs_tail="v3"): kernel B6a against its
    plain version on the live state after 12 steps at full width, word for
    word, timed by CUDA events; then the main path (8 warm-up, 32 timed
    steps) from the counts at 0, B6a launched once per observation pass and
    no other kernel; prints env-steps/s;
18. arena_mood_v3 (the flagship plus the wall_mood event, obs_tail="v3": a
    mutable background): the same for kernel B6b over the row-paired
    per-env image, with the peak device memory; walls changed vibe;
19. tithe_rrng (the tithe family stepped with reference_rng=True: the
    MT19937 twin draws the agent order, the event's shuffles and the
    query's picks; the sequential action phase): the main path at full
    width (8 warm-up and 4 timed steps, no speed target); the tithe handler
    paid, enrich fired, and the twins drew a different number of times in
    different envs;
20. GPU against CPU on flagship_v3, arena_mood_v3 and tithe_rrng (64 envs,
    max_steps 24, pool 3, 48 steps) and on arena_mood_v3 under
    reference_rng: every output and every state field but rng byte-equal,
    mt included; under reference_rng nothing but the actions and the reset
    maps is fed;
21. B1 and B2 against their plain versions on seeded synthetic inputs,
    normal and wide packing, word for word: 1, 7, 133 and 4099 envs (below,
    near and above the persistent grid), windows crossing the image edge,
    an out_w below the valid count, and an image (B1) or object tables (B2)
    that fit one stage but not two, so both the staged-ahead and the
    single-stage modes run; prints each launch's grid, warps per block,
    stages, shared memory, registers and blocks per SM;
22. B4, B5 and B6b against their plain versions on seeded synthetic
    inputs, word for word, in every mode (B4: its pooled map staged, one
    stage, its rows at a pitch rounded up to 16 bytes and sliced to out_w;
    B5: its image staged with two stages and with
    one, and read from device memory; B6b: its halves read from device
    memory): the wrapper's own plan and the plan of every other mode that
    fits, at 1, 7, 133 and 4099 envs, with windows crossing the image edge,
    an out_w below the valid count (B4's and B5's not a multiple of 4),
    globals absent a third of the time (B4, B5), B4 with 53 globals, a B4
    pool that stages at one block per SM, windows starting on even and on odd
    image rows over halves that are not any image's pairing (B6b), a B5
    image that stages at one block per SM, and one too large to stage;
    prints each launch's plan and its time by CUDA events;
23. B3 and B6a against their plain versions on seeded synthetic inputs,
    word for word (B3: its image read from device memory, normal and wide
    packing; B6a: its halves staged, one stage), at 1, 7, 133 and 4099
    envs, with windows crossing the image edge, an out_w below the valid
    count, B3 at the arena_128 image with 3, 4 and 6 token slots (12, 16
    and 23 rounds, those past 12 from shared memory), and B6a windows
    starting on even and odd image rows over halves that are not any
    image's pairing, 64x128 and 64x256; prints each launch's plan and
    time;
24. the launch limits: the GPU path against the CPU path on the general
    config with token values in base 10 (9 token slots per cell, 1092
    candidates: B5 at 35 rounds, 23 of them from shared memory; 64 envs,
    pool 3, 24 steps, every output and state field but rng byte-equal), and
    on arena_values (the flagship with value observations in base 10, 53
    global lanes: B4, its globals past 32 in rounds of their own; the same
    sizes); B1-B5,
    B6a and B6b against their plain versions at the largest candidate count
    the fused route admits to every kind (32 globals and 15 window rows of
    128 lanes: 1952 candidates, 61 rounds) and at one less (a partial last
    round), in every mode, and B4 at 53 and 64 globals with that window and
    with arena_lp's; and images at the shared-memory edge, routed by the
    route gate (obs.gate_route) to a kernel with a plan (B3, or B5 off the
    v2 gate) and launched;
25. full_combat (the reference's full-combat parity family: shield_break,
    melee loot and DirectAttack, bump_swap; per-agent loadouts; its
    reachable swap takes the Chebyshev waves, and full_token_bounds gives
    23 token slots per cell, so the non-fused observation path): B7 and B8
    against their plain versions on the live state after 12 steps at full
    width, timed; the main path (8 warm-up, 32 timed steps) from the counts
    at 0 with B7 and B8 launched once per observation pass, attacks, loot
    and swaps engaged, the Chebyshev waves per step (mean and largest) and
    the peak device memory; 8 more steps under torch.profiler for the
    launches per step, the device's busy time and idle share; then the GPU
    path against the CPU path (64 envs, pool 3, max_steps 10, 24 steps) with
    the Chebyshev waves and with the sequential phase, every output and
    every state field but rng byte-equal;
26. B7 against its plain version on seeded synthetic inputs, word for word,
    under every launch plan that holds the shapes (16-byte entries; word
    entries stored four at a time; word entries stored one at a time):
    channels per cell of 9 and 1 and of 24 and 4, an env output of partial
    16-byte units, the territory and full_combat images and a larger one,
    1, 7, 133 and 4099 envs, windows partly outside the image (row0 -1,
    lane0 at or past the last cell) and lane0 off a 16-byte unit; prints
    each launch's plan and time;
27. network (the flagship on maps with a hub, crystals and boxes: the kick
    handlers' push_object on the sequential action phase, the net:hub
    closure materialized at reset and each tick, a filtered-query reward
    and a raycast reward with a game-value range, a raycast_spawn event
    every 8 steps; a mutable background, so B2): B2 against its plain
    version on the live state after 12 steps at full width, timed; the main
    path (8 warm-up, 16 timed steps) from the counts at 0 with B2 launched
    once per observation pass; the crystals spawned, the boxes pushed and
    the net:hub members, all above zero; the peak device memory; 8 more
    steps under torch.profiler for the launches per step, the device's busy
    time and idle share;
28. GPU against CPU on network (64 envs, pool 3, max_steps 10, 24 steps)
    and on the flagship with a raycast reward (the pure-move waves with the
    grid's agent layer kept current, as the port's raycast repair sets
    them), every output and every state field but rng byte-equal;
29. the vector env at full width: MettaGridVectorEnv(make_arena(24,
    combat=False), num_envs=4096, seed=0), a pool of 8 maps, auto-reset on,
    fed numpy int32 actions from a seeded np.random.default_rng as a
    trainer feeds them: its buffers byte-equal to the port's own
    make_reset/make_step outputs (same program and maps, a generator
    seeded alike, the same actions) over 8 steps; then, from the counts at
    0, 32 timed steps with B1 launched once per step and no other kernel;
    prints the env-steps/s through the env beside the same number of
    make_step calls on the same program in the same process (actions
    already on the card, outputs left there), the CUDA-event ms of the
    device-to-host copy of a step's outputs (queued behind a spin kernel),
    and the peak device memory;
30. episode ends at full width: the same env with max_steps 16, so every
    env ends on step 16: infos["episode"] has 4096 entries, each equal to
    episode_stats, episode_rewards and length computed on the CPU from
    state_to_numpy of the state; prints the ms of that step beside the step
    before it, and of the infos alone;
31. Simulation(make_arena(24, combat=False), reference_shuffle=True),
    max_steps 24, on the card and on the CPU, stepped with the same actions
    through SimulationAgent.set_action until the episode ends:
    observations, rewards, episode_stats, grid_objects() and the episode
    signature equal at every step (the MT19937 twin draws alike on both
    devices); prints the observation route; then the signature tool
    (python -m mettagrid_tpu_torch.tools.episode_signature --steps=16) in
    two fresh processes on the card prints one hash.

32. the four policy nets (LSTMPolicy at encoder 192 and hidden 128,
    PufferDefaultNet at 256, StatelessPolicyNet at 128, the reference's
    TorchRefLSTMNet) on the card against the same nets on the CPU, weights
    copied by state_dict, on live tokens of the flagship after 8 steps at
    64 envs x 24 agents: LSTMPolicy through unroll over 4 steps, the
    recurrent nets over 4 steps, the stateless net once; prints the largest
    differences against the tolerance (1e-4: float32 sums in another order
    on each device, and the encoder's scatter_add_ in no fixed order on the
    card);
33. the policy on the flagship at full width: the lstm policy
    (TorchMultiAgentPolicy, encoder 192, hidden 128) acts for all 98,304
    agents from the engine's carried device observations, its actions going
    into make_step on the card with no host copy between (pool 64,
    auto-reset, 8 warm-up and 32 timed steps from the counts at 0: B1
    launched once per step and no other kernel); prints env-steps/s with
    the policy in the loop beside make_step alone in the same call (host
    clock), the policy's forward pass and the encoder's pooling apart
    (CUDA events), the puffer and stateless nets' forward passes at the
    same batch, and the peak device memory (below 20 GiB: no [E*A, T, H]
    intermediate, which alone would take 37.7 GB); then the same policy
    through MettaGridVectorEnv.step_batch on its numpy buffers (env-steps/s,
    and the ms to upload a step's observations), and as the env's
    supervisor (teacher actions in range);
34. Rollout and run_multi_episode (2 episodes) with the random policy on
    the card against the CPU, on a map where each agent has a room of its
    own (so the agent order, drawn by each device's generator, cannot change
    the outcome): equal steps, rewards and episode stats, and equal decoded
    replays; then run_episode_local with an lstm spec loaded from a policy
    data file, on the card: actions in range, finite logits;
35. the trainer (parallel.make_train_step) on the card against the CPU: the
    training demo's configuration (navigation, 8 envs x 2 agents, widths
    32, its random map seeded), one set of weights on both by state_dict, 5
    steps with the actions
    and agent orders fed from numpy under SGD(lr=0.1): env state and
    observations byte-equal, loss, entropy and reward mean within 1e-4
    relative, parameters and LSTM state within 1e-5; then one update of the
    port's Adam from the card's gradients copied to the CPU, within 1e-6
    (Adam is not compared end to end: its first step is close to a sign
    function, and a gradient near 0 may change sign with the order of the
    card's scatter_add_);
36. the trainer at full width: the flagship (4096 x 24, pool 64,
    auto-reset) with LSTMPolicy at encoder 192 and hidden 128 and adam(1e-3),
    8 warm-up and 16 timed train steps from the counts at 0: B1 launched once
    per env step and no other kernel, finite losses, Adam's first update at
    most 1e-3 on every parameter, the LSTM cell's bias_ih still 0, agents
    moved, peak device memory below 20 GiB; prints ms per train step and
    env-steps/s beside make_step alone (host clock), the forward pass with
    grad, the draw and the env step, the loss and its backward pass and
    optimizer.step() apart (CUDA events that train_step's mark hook records
    as the trainer issues them, over 8 more train steps) and the forward
    pass queued; then perf.run_performance on the flagship's make_step with
    max_cv=None (the host clock spreads too far for the 0.2 gate) and phase
    timing on, printing env-steps/s, the CV and the phase dict (device
    time: the step's kernels and copies, and each phase's);
37. python -m mettagrid_tpu_torch.demos.demo_train in a fresh process on
    the card (exit 0, its printed line, finite losses) and the PettingZoo
    demo on the card;
38. assembly lines at full width: make_assembly_lines(24, max_steps=1000)
    (24 MapGen instances of 6x6 perimeter rooms, two mines and two hubs
    each, balanced terrain; 60x60 maps) through
    MettaGridVectorEnv(num_envs=4096, map_pool=64, auto_reset=True) with
    random actions from numpy: route B1, 64 distinct maps, B1 launched
    once per observation pass (reset, 8 warm-up and 32 timed steps from the
    counts at 0) and no other kernel, finite outputs, agents moved; B1
    against its plain version on the live state (both packings), timed
    beside the flagship's time from phase 3; prints env-steps/s (host
    clock), the seconds the host took to build the 64 maps and the peak
    device memory;
39. a procedural BSP arena: the flagship game on a 128x128 MapGen BSP map
    (12 rooms, 24 agents and 20 walls scattered over it; 138x138 with the
    border) the same way: route B3, its image in device memory, B3 timed
    beside arena_128's time from phase 12, with its bound;
40. GPU against CPU on a small assembly-lines config (4 agents, 64 envs,
    max_steps 24, a pool of three MapGen maps, 48 steps, agent orders and
    reset maps fed from numpy): every output and every state field but rng
    byte-equal;
41. the host reference RNG (parity.ReferenceRng, std::mt19937 built by g++
    from parity/csrc/parity_rng.cpp; ``native`` asserted) against the
    engine's MT19937 twin on the card, exactly: 700 raw draws of four seeds
    across the 624-word twist, uniform_int over eight ranges, shuffle_perm
    for n in (2, 24, 97) and the draw after it;
42. the SDK: a Simulation of the flagship arena (24 agents,
    reference_shuffle, max_steps 24) on the card and one on the CPU, fed
    the same random actions; after the reset and every step, for all 24
    agents, build_state (by model_dump), decode_observation,
    StateHelperCatalog and an InMemoryMemoryStore give the same answers;
    B1 launched on the card and no other kernel;
43. the policy servers: the lstm policy (default widths, seeded) on the
    card behind LocalPolicyServer (JSON) and ProtobufPolicyServer
    (sim.policy_v1) on 127.0.0.1, each driving a Rollout of the flagship
    arena on the card (24 agents, 32 steps) through RemotePolicy and
    ProtobufRemotePolicy; every request's actions equal an in-process twin
    of the policy on the card fed the same observations; prints the median
    host ms per request;
44. the renderers and the demo: the miniscope (ASCII) and log renderers of
    phase 42's two Simulations give the same frames and lines, string for
    string; a replay written by a Rollout on the card passes
    validate_replay with no issues and replay_viewer writes its HTML;
    ``python -m mettagrid_tpu_torch.demo --steps=16 --render`` exits 0 in
    a fresh process on the card; a LiveViewer on the card serves one
    client its first frame and a step.
45. a one-rank NCCL group on the flagship trainer: init_process_group
    ("nccl") over a TCP store on 127.0.0.1 with world 1, make_mesh(1),
    shard_batch of the start, replicate of the policy; make_train_step
    with mesh= beside the one-device trainer (LSTMPolicy at its default
    widths, adam(1e-3), 4096 x 24, pool 64, auto-reset, each with its own
    make_step seeded alike) for 1 + 8 + 16 steps, both fed the actions the
    one-device policy draws from its generator: every parameter and the
    metrics bit-equal after every step (under PyTorch's deterministic mode,
    which fixes the order of the encoder histogram's scatter_add_), the env
    state and observations equal at the end, B1 launched once per env step
    of the sharded trainer; then each trainer timed over 16 steps in turns (host clock),
    the step's reduce part (flatten, all-reduce, division) by CUDA events
    from its mark hook, and one all-reduce of the flat buffer alone,
    queued, with its bytes; the group destroyed at the end;
46. two ranks sharing the card over Gloo: a one-device trainer at 4096 x
    24 (SGD 0.1, external_perm, agent orders and reset maps from numpy, its
    own draws) for 8 steps in this process, saved by rig.write_replay; then
    ``python -m mettagrid_tpu_torch.parallel.rig`` twice with --device
    cuda --backend gloo --replay, 2048 envs each: the gathered env state
    and observations equal, the losses within 1e-5 of max(1, |loss|) (the
    reference rig's bound: the loss crosses 0), the parameters
    within atol 1e-5 after the 8 steps, B1 launched 8 times in each rank;
    both ranks exit 0; prints each rank's peak device memory;
47. dryrun_multichip(1) on CUDA over NCCL: the rig's engine parity and two
    sharded train steps in a fresh process, which prints RIG_OK rank=0;
48. the cross-engine scenarios (tests/torch_parity_scenarios.SCENARIOS,
    the 18 of the JAX package's tests/test_cross_engine_parity.py, one per
    seed of its many-seeds layout: 21) through parity.cross_engine.run_ours
    on the card, each from the counts at 0: its trace has no diff_traces
    problem against the CPU's (every step's success, positions,
    inventories, observation tokens where compared, the final objects,
    rewards and episode stats), and it launched a kernel; prints each
    scenario's route and launches. A line first says that the comparison
    with the reference C++ engine was not run where its oracle is not built
    (parity.reference_oracle.reference_available); where it is, each trace
    is also held to parity.cross_engine.run_reference;
49. the seven arena families (ARENA_FAMILIES there: plain 500 steps,
    combat 500, economy 400, events 300, tithe 300, direct-attack 300,
    event-filter 200, each at the JAX test's first seeds, 24 agents, on
    parity.arena.arena_map's map) through parity.arena.run_arena_ours on
    the card, each from the counts at 0: the checkpoints, observation
    tokens, final summary, route and episode signature equal the CPU's, no
    engagement check fires; prints the route, each kernel's launches, the
    signature and ms per step (one env, so the host's pace); where the
    oracle is built, parity.arena.run_arena_parity on the card finds no
    problem. The CPU side of phases 48 and 49 runs in a process of its own
    while the card's runs;
50. each kernel that phases 48-49 launched (B1, B2, B7 and B8) against its
    plain version on the live state after 24 steps of the first family that
    launched it, timed, with its bound.

In phases 14 and 25 B7's library yardstick (``library_ms``) is one
torch.gather of the image over a precomputed index of every window word,
which computes B7's function where every window lies inside the image (the
index build is not timed); the port never calls it.

Every phase asserts. The line before the last is the kernels' JSON record;
a kernel's other cells ride in its entry under their names (B1's
"assembly_lines", B2's "network", B3's "bsp_arena", B7's and B8's
"full_combat", and "parity" for the kernels of phases 48-50, whose
launches are those of phases 48-49), each with the entry's keys. The last line is
{"ok": true, "device": {...}}. With no CUDA device, or without the
package beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import concurrent.futures
import json
import re
import subprocess
import sys
import time
import warnings

import numpy as np

# Published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, and the
# float32 rate outside the tensor cores, used as the card's 32-bit scalar rate.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

# Wrapper name -> (the TPU kernel it replaces, label).
_KERNELS = {
    "obs_tail_static_v2": ("mettagrid_tpu/engine/pallas_kernels.py:594", "B1"),
    "obs_tail_dynobj_v2": ("mettagrid_tpu/engine/pallas_kernels.py:1104", "B2"),
    "obs_tail_dyn_v2": ("mettagrid_tpu/engine/pallas_kernels.py:970", "B3"),
    "obs_tail_static_v1": ("mettagrid_tpu/engine/pallas_kernels.py:1374", "B4"),
    "obs_tail_v1": ("mettagrid_tpu/engine/pallas_kernels.py:211", "B5"),
    "obs_tail_static_v3": ("mettagrid_tpu/engine/pallas_kernels.py:792", "B6a"),
    "obs_tail_dyn_v3": ("mettagrid_tpu/engine/pallas_kernels.py:1261", "B6b"),
    "window_slices": ("mettagrid_tpu/engine/pallas_kernels.py:154", "B7"),
    "compact_rows": ("mettagrid_tpu/engine/pallas_kernels.py:110", "B8"),
}


def _card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def _time_ms(torch, fn, reps: int, queued: bool = False) -> float:
    """Mean milliseconds per call on the card, by CUDA events, after warm-up.
    Calls issued back to back run at the host's rate where it issues a call
    more slowly than the card runs it, so with ``queued`` a spin kernel
    holds the stream until the host has issued all ``reps`` calls (longer
    spins until it has): they then run back to back on the card, and the
    time is the card's alone."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = 20_000_000  # about 10 ms at the H100's clock
    for _ in range(5):
        if queued:
            torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        held = not start.query()  # the spin still held the stream after the last call was issued
        torch.cuda.synchronize()
        if held or not queued:
            return start.elapsed_time(end) / reps
        cycles *= 4
    raise RuntimeError("the host did not issue the calls within the longest spin")


def _wrappers():
    """{name: (wrapper, plain version)} of every kernel."""
    import importlib

    out = {}
    for name in _KERNELS:
        mod = importlib.import_module(f"mettagrid_tpu_torch.engine.kernels.{name}")
        out[name] = (getattr(mod, name), getattr(mod, f"{name}_ref"))
    return out


def _zero_counts():
    for kernel, _ in _wrappers().values():
        kernel.launches = 0


def _window_words(torch, args) -> int:
    """The image words inside some agent's window: the part of a per-env
    image (B3, B5) that the function must read."""
    imgp, row0, lane0, geom, S = args["imgp"], args["row0"], args["lane0"], args["geom"], args["S"]
    E, HP, WPC = imgp.shape
    Wc = WPC // S
    r = row0[..., None] + geom[:, 0]  # [E, A, K]
    c = torch.div(lane0, S, rounding_mode="floor")[..., None] + geom[:, 1]
    inside = (r >= 0) & (r < HP) & (c >= 0) & (c < Wc)
    e = torch.arange(E, device=imgp.device)[:, None, None].expand_as(r)
    mask = torch.zeros((E, HP, Wc), dtype=torch.bool, device=imgp.device)
    mask[e[inside], r[inside].long(), c[inside].long()] = True
    return int(mask.sum()) * S


def _paired_window_words(torch, args) -> int:
    """The words of the row-paired halves (B6b) that some agent's window
    reads: window row u of a window starting at image row r0 lies in half
    u & 1, row (r0 & 1) * HP2 + (r0 >> 1) + (u >> 1)."""
    left, row0, lane0, geom, S = args["imgp_l"], args["row0"], args["lane0"], args["geom"], args["S"]
    E, HP2x2, WPC = left.shape
    HP2, Wc = HP2x2 // 2, WPC // S
    u = geom[:, 0]
    row = ((row0 & 1) * HP2 + (row0 >> 1))[..., None] + (u >> 1)  # [E, A, K]
    half = (u & 1).expand_as(row)
    c = torch.div(lane0, S, rounding_mode="floor")[..., None] + geom[:, 1]
    inside = (row >= 0) & (row < HP2x2) & (c >= 0) & (c < Wc)
    e = torch.arange(E, device=left.device)[:, None, None].expand_as(row)
    mask = torch.zeros((E, 2, HP2x2, Wc), dtype=torch.bool, device=left.device)
    mask[e[inside], half[inside].long(), row[inside].long(), c[inside].long()] = True
    return int(mask.sum()) * S


def _tail_record(torch, obs_fn, state):
    """The tail kernel of ``obs_fn`` against its plain version on a live
    state (each packing the kernel takes), its CUDA-event times and the
    bound computed from these inputs."""
    kernel = obs_fn.tail
    name = kernel.__name__
    plain = _wrappers()[name][1]
    label = _KERNELS[name][1]
    args = obs_fn.tail_inputs(state)
    packings = [{"wide": False}, {"wide": True}] if obs_fn.wide is not None else [{}]
    err = 0
    for kw in packings:
        kw = dict(kw, out_w=obs_fn.out_w)
        kw_, ka = kernel(**args, **kw)
        rw, ra = plain(**args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(kw_, rw), f"{label} words differ from the plain version ({kw})"
        assert torch.equal(ka, ra), f"{label} attempted counts differ from the plain version ({kw})"
        err = max(err, int((kw_.long() - rw.long()).abs().max()), int((ka.long() - ra.long()).abs().max()))
    assert int(ka.min()) > 0
    call = dict(out_w=obs_fn.out_w, **({} if obs_fn.wide is None else {"wide": obs_fn.wide}))
    kernel_ms = _time_ms(torch, lambda: kernel(**args, **call), 50, queued=True)
    call_ms = _time_ms(torch, lambda: kernel(**args, **call), 50)
    plain_ms = _time_ms(torch, lambda: plain(**args, **call), 5)

    tensors = {k: v for k, v in args.items() if isinstance(v, torch.Tensor)}
    E, A = args["row0"].shape
    front = args.get("gplus", args.get("gwords"))
    K = args["geom"].shape[0]
    S = args["S"] if "S" in args else args["words"].shape[2]
    bytes_in = sum(t.numel() * t.element_size() for t in tensors.values())
    if "imgp" in args:  # an image in device memory: only the window words must be read
        bytes_in += (_window_words(torch, args) - args["imgp"].numel()) * 4
    if "imgp_l" in args:  # the paired halves in device memory: the same
        bytes_in += (_paired_window_words(torch, args) - 2 * args["imgp_l"].numel()) * 4
    bytes_out = E * A * obs_fn.out_w * 4 + E * A * 4
    # One test per candidate, and one add per object word for B2's image
    # (per agent word and half for B6a's).
    adds = {"obs_tail_dynobj_v2": 1, "obs_tail_static_v3": 2}.get(name, 0)
    ops = E * A * (front.shape[2] + K * S) + adds * (args["words"].numel() if adds else 0)
    return _record(name, err, kernel_ms, call_ms, plain_ms, bytes_in + bytes_out, ops)


def _times(rec: dict) -> str:
    """A kernel's record (_record) as text: its times and bound."""
    return (f"kernel {rec['ms']:.4f} ms ({rec['call_ms']:.4f} per call back to back), plain {rec['plain_ms']:.4f} ms, "
            f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")


def _plan_note(kernel) -> str:
    """The launch plan of a persistent tail's last launch (B1-B5, B6a, B6b)."""
    p = kernel.last_launch
    return (f"grid {p['grid']} ({p['blocks_per_sm']} blocks per SM), {p['warps']} warps, {p['mode']} mode, "
            f"{p['stages']} stage(s), {p['smem_bytes']} bytes of shared memory, {p['registers']} registers"
            + (f", row pitch {p['pitch']} words" if "pitch" in p else ""))


def _record(name: str, err: int, kernel_ms: float, call_ms: float, plain_ms: float, bytes_moved: int,
            ops: int) -> dict:
    """A kernel's entry of the kernels line: ``ms`` the card's time per
    launch (queued launches), ``call_ms`` the wrapper's time per call issued
    back to back (the host's rate where it is the slower); the bound is the
    larger of the bytes over the card's memory rate and the operations over
    its scalar rate. ``library_ms`` stays None where no single PyTorch call
    computes the function (every kernel but B7, whose caller times a
    gather)."""
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / SCALAR_OPS_PER_S * 1e3
    return {
        "name": name,
        "route": "cuda",
        "source": f"mettagrid_tpu_torch/engine/csrc/{name}.cu",
        "replaces": _KERNELS[name][0],
        "launches": None,
        "equal": True,
        "max_abs_err": err,
        "ms": kernel_ms,
        "call_ms": call_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }


def _kernel_record(torch, name: str, args: dict, bytes_moved: int, ops: int) -> dict:
    """Kernel ``name`` against its plain version on ``args``, word for word,
    with both timed by CUDA events."""
    kernel, plain = _wrappers()[name]
    got, ref = kernel(**args), plain(**args)
    torch.cuda.synchronize()
    assert torch.equal(got, ref), f"{_KERNELS[name][1]} differs from its plain version"
    err = int((got.long() - ref.long()).abs().max())
    kernel_ms = _time_ms(torch, lambda: kernel(**args), 50, queued=True)
    call_ms = _time_ms(torch, lambda: kernel(**args), 50)
    plain_ms = _time_ms(torch, lambda: plain(**args), 5)
    return _record(name, err, kernel_ms, call_ms, plain_ms, bytes_moved, ops)


def _timed_path(torch, bench, n_timed: int, *kernels):
    """A variant's main path from the counts at 0: reset, warm-up and n_timed
    steps. Asserts that each of ``kernels`` launched once per observation
    pass and no other kernel launched; returns (state, out, seconds,
    launches of the first kernel)."""
    from mettagrid_tpu_torch.tools.bench_run import AGENTS, ENVS, WARMUP

    _zero_counts()
    state, out = bench.warmed_up()
    state, out, dt = bench.timed(state, out, n_timed)
    launches = {name: k.launches for name, (k, _) in _wrappers().items()}
    want = 1 + WARMUP + n_timed
    names = [k.__name__ for k in kernels]
    for name in names:
        assert launches[name] == want, f"{name} launched {launches[name]} times for {want} obs passes"
    others = {k: v for k, v in launches.items() if k not in names and v}
    assert not others, f"the {bench.variant} path launched other kernels: {others}"
    T = bench.program.num_tokens
    assert tuple(out.observations.shape) == (ENVS, AGENTS, T, 3) and out.observations.dtype == torch.uint8
    assert torch.isfinite(out.rewards).all() and torch.isfinite(state.game_stats).all()
    assert torch.isfinite(state.episode_rewards).all()
    assert int(out.tokens_attempted.min()) > 0, "an agent attempted no tokens"
    return state, out, dt, launches[names[0]]


def _main_path(torch, card: str):
    """Phases 3 and 4 on the flagship at full width."""
    from mettagrid_tpu_torch.engine.kernels.obs_tail_static_v2 import obs_tail_static_v2
    from mettagrid_tpu_torch.tools.bench_run import AGENTS, ENVS, POOL, BenchRun

    flagship = BenchRun("flagship", seed=1234)

    # --- phase 3: kernel vs plain on the live state after 16 steps ---
    state, out = flagship.run(*flagship.reset(0), 16)
    record = _tail_record(torch, flagship.step.obs_fn, state)
    print(f"[3] B1 equal to its plain version (normal and wide packing): "
          f"{_times(record)}; {_plan_note(obs_tail_static_v2)}", flush=True)

    # --- phase 4: the main path, counts from 0 ---
    n_timed = 64
    state, out, dt, launches = _timed_path(torch, flagship, n_timed, obs_tail_static_v2)
    moved = int((state.obj_r[:, :AGENTS] != state.agent_spawn_r).sum())
    assert moved > 0, "no agent moved"
    record["launches"] = launches
    print(f"[4] flagship main path, {ENVS} envs x {AGENTS} agents, pool {POOL}, auto-reset, obs carried: "
          f"{ENVS * n_timed / dt:.0f} env-steps/s, {dt / n_timed * 1e3:.3f} ms/step (host clock over {n_timed} "
          f"steps) on {card}; B1 launches {launches}", flush=True)
    return record


def _gpu_vs_cpu(torch, variant: str, pool: int, E: int, n_steps: int, max_steps: int, armed: bool = False,
                change=None, reference_rng=None, action_mode: str = "auto", cfg=None):
    """The card's path against the CPU plain path, byte for byte, with agent
    orders, reset maps and (where the config has events) event ranks drawn
    with numpy and fed to both; ``change(cfg)`` edits the variant's config
    first. Under the reference-RNG step (the variant's, or ``reference_rng``)
    only the actions and the reset maps are fed: the MT19937 twin draws the
    rest on each device. full_combat takes its loadouts and its family's
    action script. ``cfg``, where given, is run in place of the variant's
    config, ``variant`` then only naming it. Returns the card's trace of
    (state, outputs) as numpy, one entry per step and one for the reset."""
    from mettagrid_tpu_torch.engine import make_reset, make_step
    from mettagrid_tpu_torch.engine.interop import state_to_numpy
    from mettagrid_tpu_torch.tools.bench_run import build_pool, full_combat_script, make_cfg, variant_options

    if cfg is None:
        cfg = make_cfg(variant)
    if armed:
        cfg.game.agent.inventory.initial = {"laser": 5, "armor": 1, "heart": 9}
    if change is not None:
        change(cfg)
    full_combat = variant == "full_combat"
    program, init = build_pool(cfg, pool, max_steps=max_steps, loadouts=full_combat)
    opts = variant_options(variant)
    if reference_rng is not None:
        opts["reference_rng"] = reference_rng
    rrng = opts["reference_rng"]
    A = program.num_agents
    n_actions = len(program.action_names)
    names = program.action_names
    angry = names.index("change_vibe_angry") if "change_vibe_angry" in names else None
    N = init.obj_type.shape[1]
    runs = {}
    for dev in ("cuda", "cpu"):
        reset = make_reset(program, init, E, device=dev, **opts)
        step = make_step(program, init, auto_reset=True, external_perm=not rrng, device=dev, action_mode=action_mode,
                         **opts)
        rng = np.random.default_rng(6)
        state, out = reset(0)
        trace = [(state_to_numpy(state), {k: v.cpu().numpy().copy() for k, v in out._asdict().items()})]
        for _ in range(n_steps):
            if full_combat:
                acts, vibes = full_combat_script(program, rng, (E, A))
            elif angry is None:
                acts = rng.integers(-1, n_actions + 1, (E, A)).astype(np.int32)
                vibes = np.zeros_like(acts)
            else:
                acts = np.where(rng.random((E, A)) < 0.8, rng.integers(0, 5, (E, A)),
                                rng.integers(-1, n_actions + 1, (E, A))).astype(np.int32)
                vibes = np.where(rng.random((E, A)) < 0.3, angry,
                                 rng.integers(-1, n_actions + 1, (E, A))).astype(np.int32)
            perm = np.stack([rng.permutation(A) for _ in range(E)]).astype(np.int32)
            maps = rng.integers(0, pool, E).astype(np.int32)
            ranks = rng.random((E, 1, N), dtype=np.float32) if program.events and not rrng else None
            t = lambda a: None if a is None else torch.from_numpy(a).to(dev)  # noqa: E731
            state, out = step(state, t(acts), t(vibes), None if rrng else t(perm), out.observations,
                              reset_maps=t(maps) if pool > 1 else None, event_ranks=t(ranks))
            trace.append((state_to_numpy(state), {k: v.cpu().numpy().copy() for k, v in out._asdict().items()}))
        runs[dev] = trace
    for i, ((gs, go), (cs, co)) in enumerate(zip(runs["cuda"], runs["cpu"])):
        for name in go:
            assert np.array_equal(go[name], co[name]), f"{variant} step {i}: output {name} differs between GPU and CPU"
        for name in gs:
            if name != "rng":
                assert np.array_equal(gs[name], cs[name]), f"{variant} step {i}: state {name} differs between GPU and CPU"
    trace = runs["cuda"]
    if rrng:
        assert trace[-1][0]["mt"].shape == (E, 625) and trace[-1][0]["mt"][:, 624].min() > 0, "the twin did not draw"
    assert trace[max_steps + 1][0]["step_count"].max() == 1, "no auto-reset in the compared window"
    if pool > 1:
        moved = sum(int((b["map_idx"] != a["map_idx"]).sum()) for (a, _), (b, _) in zip(trace, trace[1:]))
        assert moved > 0, "no auto-reset moved an env to another map"
    return program, trace


def _general_paths(torch, card: str):
    """Phases 6-8: B2 against its plain version on the live general state,
    then the general and combat main paths at full width."""
    from mettagrid_tpu_torch.engine.kernels.obs_tail_dynobj_v2 import obs_tail_dynobj_v2
    from mettagrid_tpu_torch.engine.kernels.obs_tail_static_v2 import obs_tail_static_v2
    from mettagrid_tpu_torch.tools.bench_run import AGENTS, ENVS, POOL, BenchRun

    general = BenchRun("general", seed=4321)
    program = general.program
    A = AGENTS
    heart = list(program.resource_names).index("heart")
    move_ids = torch.tensor(
        [i for i, n in enumerate(program.action_names) if n.startswith("move_")], device="cuda", dtype=torch.int32
    )

    # --- phase 6: B2 vs plain after 24 steps; count melee hits on the way ---
    state, out = general.reset(0)
    melee = 0
    for _ in range(24):
        state, out = general.run(state, out, 1)
        stayed = (state.obj_r[:, :A] == state.agent_prev_r) & (state.obj_c[:, :A] == state.agent_prev_c)
        moved_into = torch.isin(general.last_actions, move_ids)
        # A move that succeeds without moving is the melee handler applying.
        melee += int((out.action_success & stayed & moved_into).sum())
    event_stat = program.events[0].stat_id
    assert float(state.game_stats[:, event_stat].min()) >= 4, "the event did not fire at steps 4 and 20"
    record = _tail_record(torch, general.step.obs_fn, state)
    print(f"[6] B2 equal to its plain version (normal and wide packing) on the general state after 24 steps: "
          f"{_times(record)}; {_plan_note(obs_tail_dynobj_v2)}", flush=True)

    # --- phase 7: the general main path, counts from 0 ---
    n_timed = 32
    state, out, dt, launches = _timed_path(torch, general, n_timed, obs_tail_dynobj_v2)
    walls_hearts = int(state.obj_inv[:, A:, heart].sum())
    assert walls_hearts > 0 and float(state.game_stats[:, event_stat].sum()) > 0, "no event gave a wall a heart"
    assert melee > 0, "the melee handler never applied"
    record["launches"] = launches
    print(f"[7] general main path, {ENVS} envs x {A} agents, pool {POOL}, auto-reset, obs carried: "
          f"{ENVS * n_timed / dt:.0f} env-steps/s, {dt / n_timed * 1e3:.3f} ms/step (host clock over {n_timed} "
          f"steps) on {card}; B2 launches {launches}; walls hold {walls_hearts} hearts; melee applied {melee} "
          f"times in phase 6 (0 damage: the bench config gives agents no laser)", flush=True)

    # --- phase 8: the combat main path (static background, B1 wide) ---
    combat = BenchRun("combat", seed=99)
    assert combat.step.obs_fn.tail is obs_tail_static_v2 and combat.step.obs_fn.wide
    state, out, dt, wide_launches = _timed_path(torch, combat, n_timed, obs_tail_static_v2)
    R = combat.program.num_resources
    hearts_lost = int(state.auto_stats[..., R + heart].sum())
    assert hearts_lost > 0, "no attack lowered a heart"
    print(f"[8] combat main path, {ENVS} envs x {A} agents, pool {POOL}, auto-reset, obs carried: "
          f"{ENVS * n_timed / dt:.0f} env-steps/s, {dt / n_timed * 1e3:.3f} ms/step (host clock over {n_timed} "
          f"steps) on {card}; B1 launches with wide packing {wide_launches}; hearts lost to attacks {hearts_lost}",
          flush=True)
    wide = _tail_record(torch, combat.step.obs_fn, state)
    print(f"[8] B1 equal to its plain version (normal and wide packing) on the combat state, timed wide: "
          f"{_times(wide)}; {_plan_note(obs_tail_static_v2)}", flush=True)
    return record


def _new_route(torch, card: str, phase: int, variant: str, kernel, check=None):
    """Phases 10-12, 17 and 18: the variant's tail kernel against its plain
    version on the live state after 12 steps, then its main path from the
    counts at 0; ``check(bench, state)`` asserts on the main path's last
    state and returns a note for the printout."""
    from mettagrid_tpu_torch.tools.bench_run import AGENTS, ENVS, POOL, BenchRun

    torch.cuda.empty_cache()
    bench = BenchRun(variant, seed=100 + phase)
    fn = bench.step.obs_fn
    assert fn.tail is kernel, f"{variant} routes to {fn.tail.__name__}, not {kernel.__name__}"
    label = _KERNELS[kernel.__name__][1]
    state, out = bench.run(*bench.reset(0), 12)
    off_spawn = float(((state.obj_r[:, :AGENTS] != state.agent_spawn_r)
                       | (state.obj_c[:, :AGENTS] != state.agent_spawn_c)).float().mean())
    assert 0 < off_spawn < 1, "every agent on, or every agent off, its spawn cell"
    record = _tail_record(torch, fn, state)
    del state, out
    print(f"[{phase}] {label} equal to its plain version on the {variant} state after 12 steps "
          f"({off_spawn:.2f} of agents off their spawn cell): {_times(record)}"
          f"{f'; {_plan_note(kernel)}' if getattr(kernel, 'last_launch', None) else ''}", flush=True)
    n_timed = 32
    torch.cuda.reset_peak_memory_stats()
    state, out, dt, launches = _timed_path(torch, bench, n_timed, kernel)
    peak = torch.cuda.max_memory_allocated()
    record["launches"] = launches
    note = "" if check is None else f"; {check(bench, state)}"
    print(f"[{phase}] {variant} main path ({fn.route}), {ENVS} envs x {AGENTS} agents, pool {POOL}, auto-reset, "
          f"obs carried: {ENVS * n_timed / dt:.0f} env-steps/s, {dt / n_timed * 1e3:.3f} ms/step (host clock over "
          f"{n_timed} steps) on {card}; {label} launches {launches}; peak device memory {peak / 2**30:.2f} GiB{note}",
          flush=True)
    return record


def _walls_changed_vibe(bench, state) -> str:
    wall = bench.program.type_names.index("wall")
    changed = int(((state.obj_type == wall) & (state.obj_vibe != 0)).sum())
    assert changed > 0, "no wall changed vibe"
    return f"{changed} walls carry a vibe"


def _tithe_path(torch, card: str):
    """Phase 19: the tithe_rrng main path at full width from the counts at 0,
    then its tail kernel against the plain version on the path's last state."""
    from mettagrid_tpu_torch.tools.bench_run import AGENTS, ENVS, POOL, WARMUP, BenchRun

    torch.cuda.empty_cache()
    bench = BenchRun("tithe_rrng", seed=119)
    fn = bench.step.obs_fn
    assert bench.step.action_phase_kind == "sequential"
    program = bench.program
    n_timed = 4
    torch.cuda.reset_peak_memory_stats()
    state, out, dt, launches = _timed_path(torch, bench, n_timed, fn.tail)
    peak = torch.cuda.max_memory_allocated()
    # The tail on this path's own state (its N and S = 6), each packing.
    record = _tail_record(torch, fn, state)
    label = _KERNELS[fn.tail.__name__][1]
    ore = list(program.resource_names).index("ore_red")
    heart = list(program.resource_names).index("heart")
    paid = int(state.obj_inv[:, :AGENTS, ore].sum())
    enriched = float(state.game_stats[:, program.events[0].stat_id].sum())
    shrine_hearts = int(state.obj_inv[:, AGENTS:, heart].sum())
    draws = torch.unique(state.mt[:, 624]).numel()
    assert paid > 0, "the tithe handler never paid"
    assert enriched > 0 and shrine_hearts > 0, "enrich never fired"
    assert draws > 1, "the twins drew alike in every env"
    print(f"[19] tithe_rrng main path ({fn.route}, sequential actions, reference_rng), {ENVS} envs x {AGENTS} agents, "
          f"pool {POOL}, auto-reset, obs carried: {ENVS * n_timed / dt:.0f} env-steps/s, {dt / n_timed * 1e3:.3f} "
          f"ms/step (host clock over {n_timed} steps) on {card}; {fn.route} launches {launches}; ore_red paid "
          f"{paid}; shrines hold {shrine_hearts} hearts; {draws} distinct twin cursors; peak device memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    print(f"[19] {label} equal to its plain version (normal and wide packing) on the tithe_rrng state after "
          f"{WARMUP + n_timed} steps: {_times(record)}", flush=True)


def _nonfused_records(torch, fn, state):
    """The non-fused path's kernels B7 (window slices) and B8 (row
    compaction) against their plain versions on a live state, word for word,
    timed, with the bound from these inputs; B7's library yardstick is one
    torch.gather of the image over a precomputed index of every window word
    (the index build not timed), where every window lies inside the image,
    else None. Returns (B7's record, B8's, a note of the shapes and B7's
    plan)."""
    from mettagrid_tpu_torch.engine.kernels.window_slices import window_slices
    from mettagrid_tpu_torch.tools.b7_sweep import gather_index

    wargs = fn.window_inputs(state)
    E, A = wargs["row0"].shape
    K, Ch = wargs["geom"].shape[0], wargs["Ch"]
    HP, WPC = wargs["img"].shape[1:]
    # The image words inside some window are read once, the windows written once.
    window = dict(imgp=wargs["img"], row0=wargs["row0"], lane0=wargs["lane0"], geom=wargs["geom"], S=Ch)
    read = (_window_words(torch, window) + 2 * E * A + 3 * K) * 4
    b7 = _kernel_record(torch, "window_slices", wargs, read + E * A * K * Ch * 4, E * A * K * Ch)
    plan = window_slices.last_launch
    idx = gather_index(**wargs)
    if idx is not None:
        flat = wargs["img"].view(E, -1)
        assert torch.equal(torch.gather(flat, 1, idx).view(E, A, K, Ch), window_slices(**wargs))
        b7["library_ms"] = _time_ms(torch, lambda: torch.gather(flat, 1, idx), 50, queued=True)
    del wargs, window, idx
    cargs = fn.compact_inputs(state)
    R, C = cargs["words"].shape
    T = cargs["T"]
    valid = float((cargs["words"] >= 0).float().mean())
    b8 = _kernel_record(torch, "compact_rows", cargs, (R * C + R * T) * 4, R * C)
    gather = "none: a window leaves the image" if b7["library_ms"] is None else f"{b7['library_ms']:.4f} ms"
    return b7, b8, (f"({E} x {A} windows of {K} cells x {Ch} channels, image {HP}x{WPC}, "
                    f"B7 {plan['vec']}-word entries, {plan['store']}-word stores, grid {plan['grid']} "
                    f"({plan['blocks_per_sm']} blocks per SM allowed), {plan['warps']} warps, "
                    f"{plan['registers']} registers, gather yardstick {gather}; {R} rows of {C} words, {valid:.3f} "
                    f"valid, budget {T})")


def _territory_paths(torch, card: str):
    """Phases 14 and 15: B7 and B8 against their plain versions on the live
    territory state after 12 steps, then the territory main path from the
    counts at 0."""
    from mettagrid_tpu_torch.engine.kernels.compact_rows import compact_rows
    from mettagrid_tpu_torch.engine.kernels.window_slices import window_slices
    from mettagrid_tpu_torch.tools.bench_run import AGENTS, ENVS, POOL, BenchRun

    torch.cuda.empty_cache()
    bench = BenchRun("territory", seed=114)
    fn = bench.step.obs_fn
    assert fn.route == "nonfused", f"territory routes to {fn.route}"
    heart = list(bench.program.resource_names).index("heart")
    state, out = bench.reset(0)
    hearts0 = int(state.obj_inv[:, :AGENTS, heart].sum())

    # --- phase 14: B7 and B8 vs plain after 12 steps ---
    state, out = bench.run(state, out, 12)
    b7, b8, shapes = _nonfused_records(torch, fn, state)
    del state, out
    print(f"[14] B7 and B8 equal to their plain versions on the territory state after 12 steps {shapes}: "
          f"B7 {_times(b7)}; B8 {_times(b8)}", flush=True)

    # --- phase 15: the territory main path, counts from 0 ---
    n_timed = 32
    torch.cuda.reset_peak_memory_stats()
    state, out, dt, launches = _timed_path(torch, bench, n_timed, window_slices, compact_rows)
    peak = torch.cuda.max_memory_allocated()
    obs = out.observations
    mask = obs[..., 2][obs[..., 1] == bench.program.feature_ids.aoe_mask]
    friendly, enemy = int((mask == 1).sum()), int((mask == 2).sum())
    assert friendly > 0 and enemy > 0, "no friendly or no enemy AOE mask token"
    hearts = int(state.obj_inv[:, :AGENTS, heart].sum())
    assert hearts > hearts0, "the agents gained no hearts"
    b7["launches"] = b8["launches"] = launches
    print(f"[15] territory main path ({fn.route}), {ENVS} envs x {AGENTS} agents, pool {POOL}, auto-reset, obs "
          f"carried: {ENVS * n_timed / dt:.0f} env-steps/s, {dt / n_timed * 1e3:.3f} ms/step (host clock over "
          f"{n_timed} steps) on {card}; B7 and B8 launches {launches} each; AOE mask tokens friendly {friendly}, "
          f"enemy {enemy}; agents hold {hearts} hearts ({hearts0} at reset); peak device memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    return b7, b8


def _full_combat(torch, card: str):
    """Phase 25: the full_combat path at full width (B7 and B8 on its live
    state, the main path from the counts at 0, a trace of its launches and
    device time), then its GPU path against the CPU path in both action
    phases. Returns B7's and B8's figures at this path's shapes."""
    from mettagrid_tpu_torch.engine.actions_fast import footprint_schedule_ok
    from mettagrid_tpu_torch.engine.kernels.compact_rows import compact_rows
    from mettagrid_tpu_torch.engine.kernels.window_slices import window_slices
    from mettagrid_tpu_torch.tools.bench_run import AGENTS, ENVS, POOL, BenchRun
    from mettagrid_tpu_torch.tools.profile_step import trace

    torch.cuda.empty_cache()
    bench = BenchRun("full_combat", seed=125)
    fn, program = bench.step.obs_fn, bench.program
    assert fn.route == "nonfused", f"full_combat routes to {fn.route}"
    assert bench.step.action_phase_kind == "waves" and not footprint_schedule_ok(program), "not the Chebyshev waves"
    state, out = bench.run(*bench.reset(0), 12)
    b7, b8, shapes = _nonfused_records(torch, fn, state)
    del state, out
    print(f"[25] B7 and B8 equal to their plain versions on the full_combat state after 12 steps {shapes}: "
          f"B7 {_times(b7)}; B8 {_times(b8)}", flush=True)

    n_timed = 32
    torch.cuda.reset_peak_memory_stats()
    bench.waves.clear()
    state, out, dt, launches = _timed_path(torch, bench, n_timed, window_slices, compact_rows)
    peak = torch.cuda.max_memory_allocated()
    waves = bench.waves[-n_timed:]
    R = program.num_resources
    heart, ore = program.resource_names.index("heart"), program.resource_names.index("ore_red")
    lost = int(state.auto_stats[..., R + heart].sum())
    deposited = int(state.auto_stats[..., 2 * R + ore].sum())
    swaps = float(state.agent_stats[..., program.agent_stat_names.index("actions.swap")].sum())
    assert lost > 0 and deposited > 0 and swaps > 0, f"combat did not engage: {lost} hearts lost, {deposited} ore looted, {swaps} swaps"
    step_ms = dt / n_timed * 1e3
    state, out, traced = trace(bench, state, out, 8)
    busy = traced["device_busy_ms_per_step"]
    b7["launches"] = b8["launches"] = launches
    print(f"[25] full_combat main path ({fn.route}, Chebyshev waves), {ENVS} envs x {AGENTS} agents, pool {POOL}, "
          f"auto-reset, obs carried: {ENVS * n_timed / dt:.0f} env-steps/s, {step_ms:.3f} ms/step (host clock over "
          f"{n_timed} steps) on {card}; waves per step mean {sum(waves) / n_timed:.3f}, largest {max(waves)}; B7 and "
          f"B8 launches {launches} each; {traced['kernel_launches_per_step']:.1f} launches per step, device busy "
          f"{busy:.3f} ms per step, idle share {max(0.0, 1 - busy / step_ms):.3f} (traced step "
          f"{traced['step_ms_traced']:.3f} ms over 8 steps); peak device memory {peak / 2**30:.2f} GiB "
          f"({peak} bytes); {lost} hearts lost, {deposited} ore_red looted, {swaps:.0f} swaps", flush=True)
    del state, out
    torch.cuda.empty_cache()
    for mode in ("auto", "sequential"):
        _gpu_vs_cpu(torch, "full_combat", 3, 64, 24, 10, action_mode=mode)
        print(f"[25] GPU path equals the CPU path on full_combat ({'Chebyshev waves' if mode == 'auto' else mode} "
              "action phase) over 24 steps of 64 envs, pool of 3 maps, with auto-resets (every output, every state "
              "field but rng)", flush=True)
    return {k: {"launches": launches, **{f: r[f] for f in ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                                                           "library_ms")}}
            for k, r in (("B7", b7), ("B8", b8))}


def _network(torch, card: str):
    """Phase 27: the network path at full width (B2 on its live state, the
    main path from the counts at 0, a trace of its launches and device
    time). Returns B2's figures at this path's shapes."""
    from mettagrid_tpu_torch.engine.kernels.obs_tail_dynobj_v2 import obs_tail_dynobj_v2
    from mettagrid_tpu_torch.tools.bench_run import AGENTS, ENVS, POOL, BenchRun
    from mettagrid_tpu_torch.tools.profile_step import trace

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    bench = BenchRun("network", seed=127)
    fn, program = bench.step.obs_fn, bench.program
    assert fn.tail is obs_tail_dynobj_v2, f"network routes to {fn.route}"
    assert bench.step.action_phase_kind == "sequential" and not bench.step.lazy_grid
    state, out = bench.run(*bench.reset(0), 12)
    record = _tail_record(torch, fn, state)
    print(f"[27] B2 equal to its plain version (normal and wide packing) on the network state after 12 steps "
          f"(N = {state.obj_type.shape[1]}): {_times(record)}; {_plan_note(obs_tail_dynobj_v2)}", flush=True)
    del state, out

    box, crystal = program.type_names.index("box"), program.type_names.index("crystal")
    start, _ = bench.reset(0)
    boxes = start.obj_type == box
    crystals0 = int(((start.obj_type == crystal) & start.obj_alive).sum())
    del start
    n_timed = 16
    torch.cuda.reset_peak_memory_stats()
    state, out, dt, launches = _timed_path(torch, bench, n_timed, obs_tail_dynobj_v2)
    peak = torch.cuda.max_memory_allocated()
    spawned = int(((state.obj_type == crystal) & state.obj_alive).sum()) - crystals0
    # No env ends within these steps (max_steps 10000): each slot holds its reset object.
    start, _ = bench.reset(0)
    pushed = int((boxes & ((state.obj_r != start.obj_r) | (state.obj_c != start.obj_c))).sum())
    del start
    members = int(state.obj_tags[..., program.tag_names.index("net:hub")].sum())
    assert spawned > 0 and pushed > 0 and members > 0, f"{spawned} spawned, {pushed} boxes pushed, {members} members"
    step_ms = dt / n_timed * 1e3
    t1 = time.perf_counter()
    state, out, traced = trace(bench, state, out, 8, spans=False)
    t_trace = time.perf_counter() - t1
    busy = traced["device_busy_ms_per_step"]
    assert traced["kernel_launches_per_step"] > 0 and busy > 0, "the trace saw no kernel"
    record["launches"] = launches
    print(f"[27] network main path ({fn.route}, sequential actions), {ENVS} envs x {AGENTS} agents, pool {POOL}, "
          f"auto-reset, obs carried: {ENVS * n_timed / dt:.0f} env-steps/s, {step_ms:.3f} ms/step (host clock over "
          f"{n_timed} steps) on {card}; B2 launches {launches}; {traced['kernel_launches_per_step']:.1f} launches per "
          f"step, device busy {busy:.3f} ms per step, idle share {max(0.0, 1 - busy / step_ms):.3f} (traced step "
          f"{traced['step_ms_traced']:.3f} ms over 8 steps); peak device memory {peak / 2**30:.2f} GiB ({peak} "
          f"bytes); {spawned} crystals spawned, {pushed} boxes pushed, {members} net:hub members; phase 27 took "
          f"{time.perf_counter() - t0:.1f} s, the trace {t_trace:.1f} s of it", flush=True)
    return {"launches": launches, **{f: record[f] for f in ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                                                            "library_ms")}}


def _raycast_reward(cfg):
    """A per-tick reward: the objects that rays from the agents meet in
    four directions within 3 cells, walls blocking."""
    from mettagrid_tpu_torch.config.game_value import QueryCountValue
    from mettagrid_tpu_torch.config.handler_config import isA
    from mettagrid_tpu_torch.config.query import RaycastQuery
    from mettagrid_tpu_torch.config.reward_config import reward
    from mettagrid_tpu_torch.config.tag import typeTag

    ray = RaycastQuery(source=typeTag("agent"), max_range=3, blocker=[isA("wall")])
    cfg.game.agent.rewards["rays"] = reward(QueryCountValue(query=ray.model_dump()), per_tick=True)


def _network_gpu_vs_cpu(torch):
    """Phase 28: the network path and the flagship with a raycast reward, on
    the card against the CPU."""
    from mettagrid_tpu_torch.engine import make_step
    from mettagrid_tpu_torch.tools.bench_run import build_pool, make_cfg

    torch.cuda.empty_cache()
    program, trace = _gpu_vs_cpu(torch, "network", 3, 64, 24, 10)
    spawned = max(int(((s["obj_type"] == program.type_names.index("crystal")) & s["obj_alive"]).sum())
                  for s, _ in trace) - int(((trace[0][0]["obj_type"] == program.type_names.index("crystal"))
                                            & trace[0][0]["obj_alive"]).sum())
    assert spawned > 0, "no bloom spawned in the compared window"
    print("[28] GPU path equals the CPU path on network over 24 steps of 64 envs, pool of 3 maps, with auto-resets "
          f"(every output, every state field but rng; {spawned} crystals spawned at most)", flush=True)
    cfg = make_cfg("flagship")
    _raycast_reward(cfg)
    step = make_step(*build_pool(cfg, 1, max_steps=10), device="cpu")
    assert step.action_phase_kind == "waves" and not step.lazy_grid, "the raycast reward left the lazy grid on"
    program, trace = _gpu_vs_cpu(torch, "flagship", 3, 64, 24, 10, change=_raycast_reward)
    paid = sum(float(o["rewards"].sum()) for _, o in trace)
    assert paid != 0, "the raycast reward never paid"
    print("[28] GPU path equals the CPU path on the flagship with a raycast reward (pure-move waves, the agent "
          "layer kept current) over 24 steps of 64 envs, pool of 3 maps, with auto-resets", flush=True)


def _wide_window(cfg):
    """A 15x15 window with token values in base 4: window rows of more than
    128 lanes, so the non-fused path without the AOE mask."""
    cfg.game.obs.width = cfg.game.obs.height = 15
    cfg.game.obs.token_value_base = 4


def _general_gpu_vs_cpu(torch, armed: bool):
    """Phase 9: the general config, as built or armed; checks that the
    compared window holds an event and, armed, a damaging attack."""
    from mettagrid_tpu_torch.tools.bench_run import AGENTS

    program, trace = _gpu_vs_cpu(torch, "general", 3, 64, 48, 24, armed=armed)
    heart = list(program.resource_names).index("heart")
    assert trace[-1][0]["obj_inv"][:, AGENTS:, heart].sum() > 0, "no event in the compared window"
    if armed:
        lost = max(s["auto_stats"][..., program.num_resources + heart].sum() for s, _ in trace)
        assert lost > 0, "no attack lowered a heart in the compared window"
    return program, trace


def _window_geom(torch, OH: int, OW: int):
    """(u, v, loc) rows of an OH x OW window in Manhattan order from its
    centre, loc = u << 4 | v (the port's location byte)."""
    hr, wr = OH // 2, OW // 2
    cells = sorted(((u, v) for u in range(OH) for v in range(OW)), key=lambda c: (abs(c[0] - hr) + abs(c[1] - wr), c))
    return torch.tensor([[u, v, (u << 4) | v] for u, v in cells], dtype=torch.int32, device="cuda")


def _synthetic_tail_args(torch, kind: str, E: int, HP: int, WPC: int, S: int, N: int, seed: int, A: int = 24,
                         G: int = 3, OH: int = 11, OW: int = 11, fill: float = 0.4):
    """Seeded inputs of B1 ("B1"), B4 ("B4": B1's, its globals absent a
    third of the time), B2 ("B2") or B6a ("B6a": a pool of two
    halves int32[P, HP, WPC] filled independently, so no image's pairing,
    read with windows starting on even and odd image rows) at E envs:
    agents' windows mostly inside the image and a fifth of them anywhere,
    crossing its edges; B2's objects partly dead (zero words), partly
    outside the image, and some pairs on one cell. Returns (args, windows
    crossing an edge)."""
    rng = np.random.default_rng(seed)

    def words(shape, p):
        return np.where(rng.random(shape) < p, rng.integers(1, 1 << 16, shape), 0).astype(np.int32)

    r0 = rng.integers(0, HP - OH + 1, (E, A))
    l0 = rng.integers(0, (WPC - OW * S) // S + 1, (E, A)) * S
    anywhere = rng.random((E, A)) < 0.2
    r0 = np.where(anywhere, rng.integers(-OH + 1, HP, (E, A)), r0)
    l0 = np.where(anywhere, rng.integers(-OW + 1, WPC // S, (E, A)) * S, l0)
    lanes_out = (l0 < 0) | (l0 + OW * S > WPC)
    if kind == "B6a":  # window row u reads half row (r0 & 1) * HP / 2 + (r0 >> 1) + (u >> 1)
        base = (r0 & 1) * (HP // 2) + (r0 >> 1)
        crossing = int(((base < 0) | (base + (OH - 1) // 2 >= HP) | lanes_out).sum())
    else:
        crossing = int(((r0 < 0) | (r0 + OH > HP) | lanes_out).sum())
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).cuda()  # noqa: E731
    front = {"gwords": t(words((E, A, G), 2 / 3))} if kind == "B4" else {"gplus": t(words((E, A, G), 0.9))}
    args = dict(row0=t(r0), lane0=t(l0), **front, geom=_window_geom(torch, OH, OW))
    if kind in ("B1", "B4", "B6a"):
        P = 5
        pool = dict(static_imgp=t(words((P, HP, WPC), fill))) if kind != "B6a" else dict(
            static_l=t(words((P, HP, WPC), fill)), static_r=t(words((P, HP, WPC), fill)))
        # B6a's agents sit on image row 1 or below (the pairing holds no row 0).
        rext = r0 + OH // 2 if kind != "B6a" else np.maximum(r0 + OH // 2, 1)
        args.update(**pool, map_idx=t(rng.integers(0, P, E)), rext=t(rext), lext=t(l0 + (OW // 2) * S),
                    words=t(words((E, A, S), 0.7)))
    else:
        rext = rng.integers(-2, HP + 2, (E, N))
        lext = rng.integers(-2, WPC // S + 2, (E, N)) * S
        rext[:, 1], lext[:, 1] = rext[:, 0], lext[:, 0]  # two objects on one cell
        w = words((E, N, S), 0.8)
        w[rng.random((E, N)) < 0.2] = 0  # dead objects
        args.update(rext=t(rext), lext=t(lext), words=t(w), HP=HP, WPC=WPC)
    return args, crossing


def _synthetic_tails(torch):
    """Phase 21: B1 and B2 against their plain versions on seeded synthetic
    inputs, both packings, at every shape the persistent design branches on:
    E below, near and above the persistent grid, windows crossing the image
    edge (the checked loop), an out_w below the valid count (dropped ranks),
    and images or object tables that fit one stage but not two (the
    single-stage mode). Prints each launch's plan."""
    wrappers = _wrappers()
    cases = [("B1", E, 48, 128, 3, 0, 256) for E in (1, 7, 133, 4099)]
    cases += [("B1", 133, 48, 128, 3, 0, 64), ("B1", 133, 40, 768, 3, 0, 256)]
    cases += [("B2", E, 48, 256, 6, 130, 512) for E in (1, 7, 133, 4099)]
    cases += [("B2", 133, 48, 256, 6, 1500, 128), ("B2", 133, 48, 256, 6, 3000, 512)]
    modes = set()
    for i, (kind, E, HP, WPC, S, N, out_w) in enumerate(cases):
        name = "obs_tail_static_v2" if kind == "B1" else "obs_tail_dynobj_v2"
        kernel, plain = wrappers[name]
        args, crossing = _synthetic_tail_args(torch, kind, E, HP, WPC, S, N, seed=2100 + i)
        for wide in (False, True):
            got_w, got_a = kernel(**args, out_w=out_w, wide=wide)
            ref_w, ref_a = plain(**args, out_w=out_w, wide=wide)
            torch.cuda.synchronize()
            assert torch.equal(got_w, ref_w), f"{kind} words differ from the plain version (case {i}, wide {wide})"
            assert torch.equal(got_a, ref_a), f"{kind} attempted counts differ from the plain version (case {i})"
        plan = kernel.last_launch
        modes.add((kind, plan["stages"] > 1))
        dropped = int((ref_a - out_w).clamp(min=0).sum())
        print(f"[21] {kind} equal to its plain version (normal and wide packing): E {E}, image {HP}x{WPC}, S {S}"
              f"{f', N {N}' if kind == 'B2' else ''}, out_w {out_w}; {crossing} windows cross the image edge, "
              f"{dropped} ranks dropped; grid {plan['grid']} ({plan['blocks_per_sm']} blocks per SM on {plan['sms']} "
              f"SMs), {plan['warps']} warps per block, {plan['stages']} stage(s), "
              f"{plan['smem_bytes']} bytes of shared memory, {plan['registers']} registers, {plan['rounds']} rounds",
              flush=True)
        assert crossing > 0 or E < 7, "no window crosses the image edge"
        if out_w < 256:
            assert dropped > 0, "no rank was dropped"
        del args, got_w, got_a, ref_w, ref_a
    assert modes == {("B1", True), ("B1", False), ("B2", True), ("B2", False)}, f"stage modes run: {modes}"


def _synthetic_window_args(torch, kind: str, E: int, HP: int, WPC: int, S: int, G: int, seed: int, A: int = 24,
                           OH: int = 11, OW: int = 11, fill: float = 0.4):
    """Seeded inputs of B3 ("B3": per-env images int32[E, HP, WPC]), B5
    ("B5": the same, globals absent a third of the time) or B6b ("B6b": two
    halves int32[E, HP, WPC] filled independently, so no image's pairing,
    read with windows starting on even and odd image rows) at E envs:
    agents' windows mostly inside the image and a fifth of them anywhere,
    crossing its edges. Returns (args, windows crossing an edge, a note for
    the printout)."""
    rng = np.random.default_rng(seed)

    def words(shape, p):
        return np.where(rng.random(shape) < p, rng.integers(1, 1 << 16, shape), 0).astype(np.int32)

    # B6b's window from image row r reads half rows (r & 1) * HP2 + (r >> 1)
    # + (u >> 1): inside both halves of HP = 2 * HP2 rows for 0 <= r <= HP - OH.
    r0 = rng.integers(0, HP - OH + 1, (E, A))
    l0 = rng.integers(0, (WPC - OW * S) // S + 1, (E, A)) * S
    anywhere = rng.random((E, A)) < 0.2
    r0 = np.where(anywhere, rng.integers(-OH + 1, HP, (E, A)), r0)
    l0 = np.where(anywhere, rng.integers(-OW + 1, WPC // S, (E, A)) * S, l0)
    lanes_out = (l0 < 0) | (l0 + OW * S > WPC)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).cuda()  # noqa: E731
    args = dict(row0=t(r0), lane0=t(l0), geom=_window_geom(torch, OH, OW), S=S)
    if kind in ("B3", "B5"):
        crossing = int(((r0 < 0) | (r0 + OH > HP) | lanes_out).sum())
        front = words((E, A, G), 2 / 3 if kind == "B5" else 0.9)
        args.update(imgp=t(words((E, HP, WPC), fill)), **{"gwords" if kind == "B5" else "gplus": t(front)})
        note = f"{int((front == 0).sum())} absent globals"
    else:
        HP2 = HP // 2
        base = (r0 & 1) * HP2 + (r0 >> 1)
        crossing = int(((base < 0) | (base + (OH - 1) // 2 >= HP) | lanes_out).sum())
        args.update(imgp_l=t(words((E, HP, WPC), fill)), imgp_r=t(words((E, HP, WPC), fill)),
                    gplus=t(words((E, A, G), 0.9)))
        odd = int((r0 & 1).sum())
        note = f"windows on {r0.size - odd} even and {odd} odd image rows"
        assert E < 7 or 0 < odd < r0.size, "windows start on one parity only"
    return args, crossing, note


def _per_env_tails(torch):
    """Phase 22: B4, B5 and B6b against their plain versions on seeded
    synthetic inputs, in every mode (the wrapper's plan, then the plan of
    each other stage count that fits and holds, launched alone; B4's rows at
    a pitch rounded up to 16 bytes), at E below, near and above the
    persistent grid, windows crossing
    the image edge, dropped ranks (B4 and B5 at an out_w that is not a
    multiple of 4), absent globals (B4, B5), B4 at arena_lp's 48x128 pool
    with 5 globals, and with 53 (value observations: globals past the first
    round), B4 at a 40x768 pool that stages at one block per SM, both window
    parities over halves that no image pairs (B6b), a B5 image that stages
    at one block per SM (40x768) and one too large to stage (144x512).
    Prints each launch's plan and its time (CUDA events, the mean of 20
    queued launches after one warm-up)."""
    from mettagrid_tpu_torch.engine.kernels import obs_tail_dyn_v3, obs_tail_static_v1, obs_tail_v1

    mods = {"B4": obs_tail_static_v1, "B5": obs_tail_v1, "B6b": obs_tail_dyn_v3}
    # (kind, E, rows of the image or of each half, WPC, S, G, out_w)
    cases = [("B4", E, 48, 128, 3, 5, 389) for E in (1, 7, 133, 4099)]
    cases += [("B4", 133, 48, 128, 3, 5, 133), ("B4", 4099, 48, 128, 3, 53, 437), ("B4", 133, 40, 768, 3, 5, 389)]
    cases += [("B5", E, 48, 256, 6, 5, 512) for E in (1, 7, 133, 4099)]
    cases += [("B5", 133, 48, 256, 6, 5, 133), ("B5", 4099, 40, 768, 6, 5, 512), ("B5", 133, 144, 512, 6, 5, 512)]
    cases += [("B6b", E, 64, 256, 4, 3, 384) for E in (1, 7, 133, 4099)]
    cases += [("B6b", 133, 64, 256, 4, 3, 128)]
    ran = set()
    for i, (kind, E, HP, WPC, S, G, out_w) in enumerate(cases):
        mod = mods[kind]
        name = mod.__name__.rsplit(".", 1)[1]
        kernel, plain = getattr(mod, name), getattr(mod, f"{name}_ref")
        if kind == "B4":
            args, crossing = _synthetic_tail_args(torch, "B4", E, HP, WPC, S, 0, seed=2200 + i, G=G)
            note = f"{int((args['gwords'] == 0).sum())} absent globals"
        else:
            args, crossing, note = _synthetic_window_args(torch, kind, E, HP, WPC, S, G, seed=2200 + i)
        ref_w, ref_a = plain(**args, out_w=out_w)
        records = _forced_records(torch, mod, kind, kernel, args, dict(out_w=out_w), HP, WPC, S, G, out_w)
        _check_records(torch, kind, records, ref_w, ref_a, f"case {i}")
        dropped = int((ref_a - out_w).clamp(min=0).sum())
        for how, _, _, plan, ms in records:
            ran.add((kind, plan["stages"]))
            shape = {"B4": "pool", "B5": "image", "B6b": "halves"}[kind]
            print(f"[22] {kind} equal to its plain version: E {E}, {shape} {HP}x{WPC}, "
                  f"S {S}, G {G}, out_w {out_w}; {crossing} windows cross the image edge, {dropped} ranks dropped, "
                  f"{note}; {how} plan: {_plan_text(plan)}; {ms:.4f} ms", flush=True)
        assert crossing > 0 or E < 7, "no window crosses the image edge"
        if out_w < 256:
            assert dropped > 0, "no rank was dropped"
        del args, records, ref_w, ref_a
    want = {("B4", 1), ("B5", 0), ("B5", 1), ("B5", 2), ("B6b", 0)}
    assert ran == want, f"modes run: {sorted(ran)}"


def _forced_records(torch, mod, kind: str, kernel, args: dict, call: dict, HP: int, WPC: int, S: int, G: int,
                    out_w: int, reps: int = 20):
    """The wrapper's launch of ``kernel`` on ``args``, then one launch under
    the plan of each other stage count of ``kind`` that fits and holds
    (``mod.launch_plans([plan])``): a list of (how, words, attempted, the
    launch's record, ms by CUDA events over ``reps`` queued launches)."""
    from mettagrid_tpu_torch.engine.kernels import tail_plan

    A, K = args["row0"].shape[1], args["geom"].shape[0]
    N = args["rext"].shape[1] if kind == "B2" else 0
    got_w, got_a = kernel(**args, **call)
    records = [("wrapper", got_w, got_a, kernel.last_launch,
                _time_ms(torch, lambda: kernel(**args, **call), reps, queued=True))]
    for stages in tail_plan.STAGE_COUNTS[kind]:
        plan = tail_plan.plan_for(kind, stages, HP, WPC, A, G, K, S, out_w, N)
        if plan and stages != kernel.last_launch["stages"] and not tail_plan.refusal(kind, plan, HP, WPC, G, S, out_w):
            ms = _time_ms(torch, lambda: mod.launch_plans([plan], **args, **call), reps, queued=True)
            records.append(("forced", *mod.launch_plans([plan], **args, **call), ms))
    torch.cuda.synchronize()
    return records


def _check_records(torch, kind: str, records, ref_w, ref_a, case: str):
    """Every launch of ``records`` (_forced_records) equal to the plain
    version's words and counts."""
    for how, words_, att, plan, _ in records:
        assert torch.equal(words_, ref_w), f"{kind} words differ from the plain version ({case}, {how} {plan})"
        assert torch.equal(att, ref_a), f"{kind} attempted counts differ from the plain version ({case}, {how})"


def _plan_text(plan: dict) -> str:
    """A launch's record (the wrappers' ``last_launch``) as text."""
    return (f"{plan['mode']} mode, {plan['stages']} stage(s), grid {plan['grid']} ({plan['blocks_per_sm']} blocks per "
            f"SM on {plan['sms']} SMs), {plan['warps']} warps per block, {plan['smem_bytes']} bytes of shared memory, "
            f"{plan['registers']} registers, {plan['rounds']} rounds"
            + (f", row pitch {plan['pitch']} words" if "pitch" in plan else ""))


def _b3_b6a_tails(torch):
    """Phase 23: B3 and B6a against their plain versions on seeded synthetic
    inputs, in every mode (B3 both packings), at E below, near and above
    the persistent grid, windows crossing the image edge, dropped ranks, B3
    at the arena_128 image with S = 3, 4 and 6 (12 rounds in registers; 16
    and 23 rounds, those past 12 in shared memory), and B6a on both window
    parities over halves that no image pairs, flagship_v3's 64 x 128 and
    halves of 64 x 256. Prints each launch's plan and its time (CUDA events,
    the mean of 20 launches after one warm-up)."""
    from mettagrid_tpu_torch.engine.kernels import obs_tail_dyn_v2, obs_tail_static_v3

    # (kind, E, rows of the image or of each half, WPC, S, out_w)
    cases = [("B3", E, 48, 256, 3, 256) for E in (1, 7, 133, 4099)]
    cases += [("B3", 133, 144, 512, S, 256) for S in (3, 4, 6)] + [("B3", 133, 48, 256, 3, 128)]
    cases += [("B6a", E, 64, 128, 3, 256) for E in (1, 7, 133, 4099)]
    cases += [("B6a", 133, 64, 256, 3, 256), ("B6a", 133, 64, 128, 3, 128)]
    ran = set()
    for i, (kind, E, HP, WPC, S, out_w) in enumerate(cases):
        G = 3
        if kind == "B3":
            mod, kernel, plain = obs_tail_dyn_v2, obs_tail_dyn_v2.obs_tail_dyn_v2, obs_tail_dyn_v2.obs_tail_dyn_v2_ref
            args, crossing, note = _synthetic_window_args(torch, "B3", E, HP, WPC, S, G, seed=2300 + i)
            packings = [{"wide": False}, {"wide": True}]
        else:
            mod, kernel, plain = (obs_tail_static_v3, obs_tail_static_v3.obs_tail_static_v3,
                                  obs_tail_static_v3.obs_tail_static_v3_ref)
            args, crossing = _synthetic_tail_args(torch, "B6a", E, HP, WPC, S, 0, seed=2300 + i, G=G)
            odd = int((args["row0"] & 1).sum())
            note = f"windows on {args['row0'].numel() - odd} even and {odd} odd image rows"
            assert E < 7 or 0 < odd < args["row0"].numel(), "windows start on one parity only"
            packings = [{}]
        for kw in packings:
            call = dict(kw, out_w=out_w)
            ref_w, ref_a = plain(**args, **call)
            records = _forced_records(torch, mod, kind, kernel, args, call, HP, WPC, S, G, out_w)
            _check_records(torch, kind, records, ref_w, ref_a, f"case {i}, {kw}")
            dropped = int((ref_a - out_w).clamp(min=0).sum())
            for how, _, _, plan, ms in records:
                ran.add((kind, plan["stages"], plan["rounds"]))
                print(f"[23] {kind} equal to its plain version{f' ({kw})' if kw else ''}: E {E}, "
                      f"{'image' if kind == 'B3' else 'halves'} {HP}x{WPC}, S {S}, G {G}, out_w {out_w}; {crossing} "
                      f"windows cross the image edge, {dropped} ranks dropped, {note}; {how} plan: "
                      f"{_plan_text(plan)}; {ms:.4f} ms", flush=True)
            assert crossing > 0 or E < 7, "no window crosses the image edge"
            if out_w < 256:
                assert dropped > 0, "no rank was dropped"
            del records, ref_w, ref_a
        del args
    want = {("B3", 0, 12), ("B3", 0, 16), ("B3", 0, 23), ("B6a", 1, 12)}
    assert ran == want, f"modes and rounds run: {sorted(ran)}"


def _synthetic_windows(torch):
    """Phase 26: B7 against its plain version on seeded synthetic inputs,
    word for word, under every plan that holds the shapes (window_plans,
    each launched alone by launch_plan): Ch = 9 and 1 (word entries, stored
    four at a time and one at a time) and 24 and 4 (16-byte entries too);
    an env output of partial 16-byte units (23 agents of 121 x 1 words);
    territory's 40 x 384 image, full_combat's 40 x 896 and 40 x 1024, and
    144 x 512; E at 1, 7, 133 and 4099 (below, near and above the
    persistent grid); windows partly outside the image (row0 -1, lane0 at
    or past the last cell) and lane0 off a 16-byte unit. Prints each
    launch's plan and its time (CUDA events, the mean of 20 queued launches
    after one warm-up)."""
    from mettagrid_tpu_torch.engine.kernels import window_slices as b7

    OH = OW = 11
    geom = _window_geom(torch, OH, OW)
    cases = [(E, 24, 40, 384, 9) for E in (1, 7, 133, 4099)]
    cases += [(133, 24, 40, 896, 24), (4099, 24, 40, 1024, 24), (133, 24, 40, 384, 4), (133, 24, 32, 128, 1),
              (133, 23, 32, 128, 1), (133, 24, 144, 512, 9), (133, 24, 144, 512, 24)]
    ran = set()
    for i, (E, A, HP, WPC, Ch) in enumerate(cases):
        rng = np.random.default_rng(2600 + i)
        cells = WPC // Ch
        img = rng.integers(-(1 << 20), 1 << 20, (E, HP, WPC)).astype(np.int32)
        r0 = rng.integers(0, HP - OH + 1, (E, A))
        l0 = rng.integers(0, cells - OW + 1, (E, A)) * Ch
        edge = rng.random((E, A))
        r0 = np.where(edge < 0.1, -1, np.where(edge < 0.15, HP - OH + 1, r0))
        l0 = np.where((edge >= 0.15) & (edge < 0.2), cells * Ch, np.where((edge >= 0.2) & (edge < 0.25),
                      (cells - OW + 2) * Ch, l0))
        l0 = np.where((edge >= 0.25) & (edge < 0.3), l0 + 1, l0)  # off a 16-byte unit
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).cuda()  # noqa: E731
        args = dict(img=t(img), row0=t(r0), lane0=t(l0), geom=geom, Ch=Ch)
        crossing = int(((r0 < 0) | (r0 + OH > HP) | (l0 < 0) | (l0 + OW * Ch > WPC)).sum())
        assert crossing > 0 or E < 7, "no window leaves the image"
        ref = b7.window_slices_ref(**args)
        got = b7.window_slices(**args)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), f"B7 differs from its plain version (case {i}, the wrapper's plan)"
        wrapper = b7.window_slices.last_launch
        for plan in b7.window_plans(WPC, A, OH * OW, Ch):
            got, record = b7.launch_plan(plan, **args)
            torch.cuda.synchronize()
            assert torch.equal(got, ref), f"B7 differs from its plain version (case {i}, {plan})"
            ms = _time_ms(torch, lambda: b7.launch_plan(plan, **args), 20, queued=True)
            ran.add((plan.vec, plan.store))
            chosen = " (the wrapper's)" if (record["vec"], record["store"]) == (wrapper["vec"], wrapper["store"]) else ""
            print(f"[26] B7 equal to its plain version: E {E}, A {A}, image {HP}x{WPC}, Ch {Ch}; {crossing} windows "
                  f"leave the image; plan{chosen}: {record['vec']}-word entries, {record['store']}-word stores, grid "
                  f"{record['grid']} ({record['blocks_per_sm']} blocks per SM allowed), {record['warps']} warps, "
                  f"{record['smem_bytes']} bytes of shared memory, {record['registers']} registers; {ms:.4f} ms",
                  flush=True)
        del args, got, ref
    assert ran == {(1, 1), (1, 4), (4, 4)}, f"plans run: {sorted(ran)}"


def _token_base_10(cfg):
    """Token values in base 10: 9 token slots per cell on the general
    config, 1092 candidates (35 rounds of 32)."""
    cfg.game.obs.token_value_base = 10



def _launch_limits(torch):
    """Phase 24: the general config in base 10 on the card against the CPU
    path, with B5 at 35 rounds, and arena_values (53 global lanes, B4);
    every persistent kernel against its plain version at the fused route's
    largest candidate count and one less (a partial last round), in every
    mode, and B4 at 53 and 64 globals; and images at the shared-memory edge
    routed by obs.gate_route and launched."""
    from mettagrid_tpu_torch.engine import obs as tobs
    from mettagrid_tpu_torch.engine.kernels import (
        obs_tail_dyn_v2,
        obs_tail_dyn_v3,
        obs_tail_dynobj_v2,
        obs_tail_static_v1,
        obs_tail_static_v2,
        obs_tail_static_v3,
        obs_tail_v1,
        tail_plan,
    )

    before = obs_tail_v1.obs_tail_v1.launches
    program, _ = _gpu_vs_cpu(torch, "general", 3, 64, 24, 16, change=_token_base_10)
    rec = obs_tail_v1.obs_tail_v1.last_launch
    assert obs_tail_v1.obs_tail_v1.launches > before and rec["rounds"] == 35, f"B5 did not run at 35 rounds: {rec}"
    print(f"[24] GPU path equals the CPU path on the general config in base 10 (S = "
          f"{tobs.make_stage1(program).num_slots}) over 24 steps of 64 envs, pool of 3 maps, with auto-resets and "
          f"events; B5 launched {obs_tail_v1.obs_tail_v1.launches - before} times, last plan: {_plan_text(rec)}",
          flush=True)
    b4 = obs_tail_static_v1.obs_tail_static_v1
    before = b4.launches
    program, _ = _gpu_vs_cpu(torch, "arena_values", 3, 64, 24, 16)
    G = tobs.make_obs_fn(program, None, "cpu").tail_shapes["G"]
    assert b4.launches > before and G == 53, f"arena_values ran B4 {b4.launches - before} times"
    print(f"[24] GPU path equals the CPU path on arena_values (the flagship with {G} global lanes: value observations "
          f"in base 10) over 24 steps of 64 envs, pool of 3 maps, with auto-resets; B4 launched {b4.launches - before} "
          f"times, last plan: {_plan_text(b4.last_launch)}", flush=True)

    # The largest count: 32 globals, then a 15 x 1 window of 128 slots per
    # cell; with 31 globals the last round holds one dead entry. B4 (v1
    # rows of any width, laid out at a pitch rounded up to 16 bytes) at an
    # out_w of partial 16-byte units, and past 32 globals at this window and
    # at arena_lp's.
    OH, OW, S, E, out_w = 15, 1, 128, 133, 1024
    kinds = {"B1": obs_tail_static_v2, "B2": obs_tail_dynobj_v2, "B3": obs_tail_dyn_v2, "B4": obs_tail_static_v1,
             "B5": obs_tail_v1, "B6a": obs_tail_static_v3, "B6b": obs_tail_dyn_v3}
    cases = [(G, kind, mod, OH, OW, S) for G in (32, 31) for kind, mod in kinds.items()]
    cases += [(G, "B4", obs_tail_static_v1, oh, ow, s) for G in (53, 64) for oh, ow, s in ((OH, OW, S), (11, 11, 3))]
    ran = set()
    for i, (G, kind, mod, oh, ow, s) in enumerate(cases):
        cands = G + oh * ow * s
        rounds = tail_plan.rounds_for(G, oh * ow, s, kind)
        assert G > 32 or (rounds == 61 and cands == 1920 + G)
        name = mod.__name__.rsplit(".", 1)[1]
        kernel, plain = getattr(mod, name), getattr(mod, f"{name}_ref")
        HP, WPC = 32, 256
        width = out_w - 3 if kind == "B4" else out_w
        if kind in ("B1", "B2", "B4", "B6a"):
            args, _ = _synthetic_tail_args(torch, kind, E, HP, WPC, s, 60, seed=2400 + i, G=G, OH=oh, OW=ow)
        else:
            args, _, _ = _synthetic_window_args(torch, kind, E, HP, WPC, s, G, seed=2400 + i, OH=oh, OW=ow)
        call = dict(out_w=width, **({"wide": True} if kind in ("B1", "B2", "B3") else {}))
        ref_w, ref_a = plain(**args, **call)
        records = _forced_records(torch, mod, kind, kernel, args, call, HP, WPC, s, G, width, reps=5)
        _check_records(torch, kind, records, ref_w, ref_a, f"{cands} candidates, G {G}")
        for how, _, _, plan, ms in records:
            assert plan["rounds"] == rounds
            ran.add((kind, plan["stages"], cands))
            print(f"[24] {kind} equal to its plain version at {cands} candidates (G {G}, a {oh}x{ow} window, S {s}): "
                  f"E {E}, image {HP}x{WPC}, out_w {width}, {int(ref_a.float().mean())} valid per agent on average; "
                  f"{how} plan: {_plan_text(plan)}; {ms:.4f} ms", flush=True)
        del args, records, ref_w, ref_a
    modes = {("B1", 1), ("B1", 2), ("B2", 1), ("B2", 2), ("B3", 0), ("B4", 1), ("B5", 0), ("B5", 1), ("B5", 2),
             ("B6a", 1), ("B6b", 0)}
    want = {(kind, stages, cands) for kind, stages in modes for cands in (1951, 1952)}
    want |= {("B4", 1, G + c) for G in (53, 64) for c in (1920, 363)}
    assert ran == want, f"modes run at 1951 and 1952 candidates and B4's past 32 globals: {sorted(ran)}"

    # Images at the shared-memory edge that one env's image and the candidate
    # tables fit, but no launch plan of B1 does: the gate routes them to B3,
    # and off the v2 gate (no B4 plan holds them either) to B5.
    for A, HP, WPC, OH, S, out_w in ((128, 88, 640, 11, 3, 256), (96, 88, 640, 11, 3, 512), (64, 448, 128, 5, 1, 128)):
        K = OH * OH
        assert (HP * WPC + 3 * K * S) * 4 <= tail_plan.MAX_SMEM  # one image and three candidate tables
        assert not tail_plan.holds("B1", HP, WPC, A, 3, K, S, out_w)
        assert not tail_plan.holds("B4", HP, WPC, A, 3, K, S, out_w)
        for v2_ok, want_route, mod, name in ((True, "B3", obs_tail_dyn_v2, "obs_tail_dyn_v2"),
                                             (False, "B5", obs_tail_v1, "obs_tail_v1")):
            route = tobs.gate_route(v2_ok, True, True, False, A, 3, K, S, HP, WPC, 0, out_w)
            assert route == want_route, f"the gate routes {HP}x{WPC} with {A} agents to {route}"
            args, crossing, _ = _synthetic_window_args(torch, route, 133, HP, WPC, S, 3, seed=2500 + A, A=A, OH=OH,
                                                       OW=OH)
            call = dict(out_w=out_w, **({"wide": False} if v2_ok else {}))
            kernel = getattr(mod, name)
            got = kernel(**args, **call)
            ref = getattr(mod, f"{name}_ref")(**args, **call)
            torch.cuda.synchronize()
            assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), \
                f"{route} differs at {HP}x{WPC}, {A} agents"
            print(f"[24] {HP}x{WPC} image, {A} agents, a {OH}x{OH} window, S {S}, out_w {out_w}, "
                  f"{'v2' if v2_ok else 'v1'} words: one image and the candidate tables fit a block, no "
                  f"{'B1' if v2_ok else 'B4'} plan does; routed to {route}, equal to its plain version ({crossing} "
                  f"windows cross the image edge); {_plan_text(kernel.last_launch)}", flush=True)


def _vector_env(torch, card: str):
    """Phase 29: the vector env at full width against the port's own engine,
    then timed beside make_step alone."""
    from mettagrid_tpu_torch.builder import make_arena
    from mettagrid_tpu_torch.engine import make_reset, make_step
    from mettagrid_tpu_torch.engine.kernels.obs_tail_static_v2 import obs_tail_static_v2
    from mettagrid_tpu_torch.envs import MettaGridVectorEnv

    E, n_check, n_timed = 4096, 8, 32
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    env = MettaGridVectorEnv(make_arena(24, combat=False), num_envs=E, seed=0)
    program, A, T = env.program, env.agents_per_env, env.program.num_tokens
    rng = np.random.default_rng(29)
    acts = [rng.integers(0, len(env.action_names), E * A).astype(np.int32) for _ in range(n_check + n_timed)]
    zeros = torch.zeros((E, A), dtype=torch.int32, device="cuda")

    generator = torch.Generator(device="cuda")
    generator.manual_seed(0)
    step = make_step(program, env._init, generator=generator)
    state, out = make_reset(program, env._init, E)(0)
    obs, *_ = env.reset()
    assert np.array_equal(obs, out.observations.reshape(E * A, T, 3).cpu().numpy()), "reset observations differ"
    for i, a in enumerate(acts[:n_check]):
        obs, rew, term, trunc, _ = env.step(a)
        state, out = step(state, torch.from_numpy(a).view(E, A).cuda(), zeros, None, out.observations)
        for name, got, want in (("observations", obs, out.observations), ("rewards", rew, out.rewards),
                                ("terminals", term, out.terminals), ("truncations", trunc, out.truncations)):
            assert np.array_equal(got, want.reshape(got.shape).cpu().numpy()), f"step {i}: {name} differ"
    assert env.buffers.observations is obs

    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for a in acts[n_check:]:
        env.step(a)
    dt_env = time.perf_counter() - t0
    launches = {name: k.launches for name, (k, _) in _wrappers().items() if k.launches}
    assert launches == {"obs_tail_static_v2": n_timed}, f"the vector env launched {launches} for {n_timed} steps"
    assert obs_tail_static_v2.launches == n_timed

    device_acts = [torch.from_numpy(a).view(E, A).cuda() for a in acts[n_check:]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for a in device_acts:
        state, out = step(state, a, zeros, None, out.observations)
    torch.cuda.synchronize()
    dt_step = time.perf_counter() - t0
    copy_ms = _time_ms(torch, env._copy_out, 20, queued=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    moved = sum(b.nbytes for b in (obs, rew, term, trunc))
    print(f"[29] vector env buffers equal to make_reset/make_step over {n_check} steps at {E} envs x {A} agents "
          f"(T {T}); B1 launched once per step ({n_timed} in {n_timed} timed steps). Vector env: "
          f"{E * n_timed / dt_env:.1f} env-steps/s, {dt_env / n_timed * 1e3:.3f} ms/step; make_step alone: "
          f"{E * n_timed / dt_step:.1f} env-steps/s, {dt_step / n_timed * 1e3:.3f} ms/step (host clock over "
          f"{n_timed} steps); device-to-host copy {copy_ms:.4f} ms per step for {moved} bytes "
          f"({moved / copy_ms / 1e6:.2f} GB/s, CUDA events, queued); peak device memory {peak:.2f} GiB on {card}",
          flush=True)


def _episode_ends(torch, card: str):
    """Phase 30: every env ends on one step; its infos against the stats
    computed on the CPU."""
    from mettagrid_tpu_torch.builder import make_arena
    from mettagrid_tpu_torch.engine.interop import state_from_numpy, state_to_numpy
    from mettagrid_tpu_torch.envs import MettaGridVectorEnv
    from mettagrid_tpu_torch.simulator.stats import episode_infos, episode_stats

    E, max_steps = 4096, 16
    cfg = make_arena(24, combat=False)
    cfg.game.max_steps = max_steps
    env = MettaGridVectorEnv(cfg, num_envs=E, seed=0)
    rng = np.random.default_rng(30)
    env.reset()
    times = []
    for i in range(max_steps):
        a = rng.integers(0, len(env.action_names), env.num_agents).astype(np.int32)
        t0 = time.perf_counter()
        *_, infos = env.step(a)
        times.append(time.perf_counter() - t0)
        assert ("episode" in infos) == (i == max_steps - 1), f"step {i + 1}: episode infos {'episode' in infos}"
    program = env.program
    host = state_from_numpy(state_to_numpy(env.state), "cpu")
    episodes = infos["episode"]
    assert sorted(episodes) == list(range(E)), f"{len(episodes)} episode infos for {E} envs"
    for e, ep in episodes.items():
        assert ep["stats"] == episode_stats(program, host, e), f"env {e}: stats differ"
        assert ep["episode_rewards"] == host.episode_rewards[e].tolist(), f"env {e}: episode rewards differ"
        assert ep["length"] == int(host.step_count[e]) == max_steps, f"env {e}: length differs"
    assert any(ep["stats"]["agent"][0] for ep in episodes.values())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    episode_infos(program, env.state, range(E))
    infos_ms = (time.perf_counter() - t0) * 1e3
    print(f"[30] step {max_steps} ended all {E} episodes: {len(episodes)} infos equal to episode_stats, episode "
          f"rewards and length on the CPU from state_to_numpy; that step {times[-1] * 1e3:.3f} ms against "
          f"{times[-2] * 1e3:.3f} ms for step {max_steps - 1} (host clock), the infos alone {infos_ms:.3f} ms "
          f"on {card}", flush=True)


def _simulation(torch, card: str):
    """Phase 31: a Simulation on the card against one on the CPU under the
    MT19937 twin, then the signature tool in two fresh processes."""
    from mettagrid_tpu_torch.builder import make_arena
    from mettagrid_tpu_torch.parity import episode_signature
    from mettagrid_tpu_torch.simulator import Simulation

    cfg = make_arena(24, combat=False)
    cfg.game.max_steps = 24
    gpu = Simulation(cfg, seed=31, reference_shuffle=True)
    cpu = Simulation(cfg, seed=31, reference_shuffle=True, device="cpu")
    names = gpu.action_names
    rng = np.random.default_rng(31)
    steps = 0
    while True:
        assert torch.equal(gpu.last_outputs.observations.cpu(), cpu.last_outputs.observations), f"step {steps}: obs"
        assert torch.equal(gpu.last_outputs.rewards.cpu(), cpu.last_outputs.rewards), f"step {steps}: rewards"
        assert gpu.episode_stats == cpu.episode_stats, f"step {steps}: episode_stats"
        assert gpu.grid_objects() == cpu.grid_objects(), f"step {steps}: grid_objects"
        sig = episode_signature(gpu.program, gpu.state)
        assert sig == episode_signature(cpu.program, cpu.state), f"step {steps}: signature"
        assert [t.value for t in gpu.agent(0).observation.tokens] == [t.value for t in cpu.agent(0).observation.tokens]
        if gpu.is_done or cpu.is_done:
            break
        for a in range(gpu.num_agents):
            action = names[int(rng.integers(0, len(names)))]
            gpu.agent(a).set_action(action)
            cpu.agent(a).set_action(action)
        gpu.step()
        cpu.step()
        steps += 1
    assert gpu.is_done and cpu.is_done and steps == 24
    assert int(gpu.state.mt[0, 624]) > 0
    route = gpu._step_fn.obs_fn.route
    print(f"[31] Simulation (make_arena(24), reference_shuffle, {route} route) on the card equals the CPU over "
          f"{steps} steps to the episode end: observations, rewards, episode_stats, grid_objects, signature "
          f"{sig[:16]}...", flush=True)
    cmd = [sys.executable, "-m", "mettagrid_tpu_torch.tools.episode_signature", "--steps=16"]
    hashes = []
    for _ in range(2):
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=sys.path[0] or ".")
        assert res.returncode == 0, res.stderr[-2000:]
        hashes.append(res.stdout.strip())
    assert len(set(hashes)) == 1 and len(hashes[0]) == 64, hashes
    print(f"[31] episode_signature --steps=16 in two fresh processes on the card: one hash {hashes[0]}", flush=True)


def _policy_nets(torch, card: str):
    """Phase 32: each policy net on the card against the same net on the
    CPU, on live flagship tokens."""
    from mettagrid_tpu_torch.policy import LSTMPolicy, PufferDefaultNet, StatelessPolicyNet, unroll
    from mettagrid_tpu_torch.policy.torch_compat import TorchLSTMState, TorchRefLSTMNet
    from mettagrid_tpu_torch.tools.bench_run import BenchRun

    tol = 1e-4
    bench = BenchRun("flagship", seed=32, envs=64, pool=8)
    state, out = bench.run(*bench.reset(0), 8)
    steps = []
    for _ in range(4):
        steps.append(out.observations.clone())
        state, out = bench.run(state, out, 1)
    tokens = torch.stack(steps)  # [4, 64, 24, T, 3]
    n, obs_size = len(bench.program.action_names), tokens.shape[-2] * 3
    generator = torch.Generator(device="cuda")
    generator.manual_seed(32)
    nets = {
        "lstm": (LSTMPolicy, (n,)),
        "puffer": (PufferDefaultNet, (n, obs_size)),
        "stateless": (StatelessPolicyNet, (n, obs_size)),
        "torch_ref": (TorchRefLSTMNet, (n, obs_size)),
    }
    diffs = {}
    for name, (cls, args) in nets.items():
        gpu = cls(*args, device="cuda", generator=generator)
        cpu = cls(*args, device="cpu")
        cpu.load_state_dict(gpu.state_dict())
        outs = {}
        with torch.no_grad():
            for dev, net in (("cuda", gpu), ("cpu", cpu)):
                tok = tokens.to(dev)
                if name == "lstm":
                    logits, values, st = unroll(net, tok, net.initial_state(tok.shape[1:3]))
                    outs[dev] = (logits, values, st.h, st.c)
                elif name == "stateless":
                    outs[dev] = net(tok[0])
                elif name == "puffer":
                    st = net.initial_state(tok.shape[1:3])
                    for t in range(4):
                        logits, values, st = net(tok[t], st)
                    outs[dev] = (logits, values, st.h, st.c)
                else:  # the reference's net takes flattened inputs / 255
                    flat = tok.reshape(4, -1, obs_size).float() / 255.0
                    z = torch.zeros((flat.shape[1], net.hidden_size), device=dev)
                    st = TorchLSTMState(h=z, c=z)
                    for t in range(4):
                        logits, values, st = net(flat[t], st)
                    outs[dev] = (logits, values, st.h, st.c)
        diffs[name] = max(float((g.cpu() - c).abs().max()) for g, c in zip(outs["cuda"], outs["cpu"]))
        assert all(torch.isfinite(g).all() for g in outs["cuda"]), f"{name}: non-finite output on the card"
        assert diffs[name] <= tol, f"{name}: the card differs from the CPU by {diffs[name]} > {tol}"
    print(f"[32] policy nets on the card equal the CPU within {tol} on flagship tokens after 8 steps (64 envs x 24 "
          f"agents, T {tokens.shape[-2]}), lstm over unroll of 4 steps, puffer and torch_ref over 4 steps, stateless "
          f"once; largest differences {', '.join(f'{k} {v:.3g}' for k, v in diffs.items())}", flush=True)


def _policy_path(torch, card: str):
    """Phase 33: the lstm policy driving the flagship at full width, timed
    beside make_step alone; then through the vector env's numpy buffers."""
    from mettagrid_tpu_torch.builder import make_arena
    from mettagrid_tpu_torch.engine.kernels.obs_tail_static_v2 import obs_tail_static_v2
    from mettagrid_tpu_torch.envs import MettaGridVectorEnv
    from mettagrid_tpu_torch.policy import PolicyEnvInterface, PufferDefaultNet, StatelessPolicyNet
    from mettagrid_tpu_torch.policy import TorchMultiAgentPolicy
    from mettagrid_tpu_torch.tools.bench_run import AGENTS, ENVS, POOL, WARMUP, BenchRun

    info = PolicyEnvInterface.from_config(make_arena(AGENTS, combat=False))
    n_timed = 32
    bench = BenchRun("flagship", seed=33)
    policy = TorchMultiAgentPolicy(info, seed=33)
    acts = torch.zeros((ENVS, AGENTS), dtype=torch.int32, device="cuda")
    vibes = torch.zeros_like(acts)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    def drive(state, out, n):
        for _ in range(n):
            policy.step_batch(out.observations, acts)
            state, out = bench.step(state, acts, vibes, None, out.observations)
        return state, out

    _zero_counts()
    state, out = drive(*bench.reset(0), WARMUP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, out = drive(state, out, n_timed)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {name: k.launches for name, (k, _) in _wrappers().items() if k.launches}
    want = 1 + WARMUP + n_timed
    assert launches == {"obs_tail_static_v2": want}, f"the policy path launched {launches} for {want} obs passes"
    peak = torch.cuda.max_memory_allocated() / 2**30
    assert peak < 20, f"peak device memory {peak:.2f} GiB"
    assert 0 <= int(acts.min()) and int(acts.max()) < len(info.action_names)
    assert int((state.obj_r[:, :AGENTS] != state.agent_spawn_r).sum()) > 0, "no agent moved"
    assert policy._lstm_state.h.shape == (ENVS, AGENTS, 128) and torch.isfinite(policy._lstm_state.h).all()
    state, out, dt_step = bench.timed(state, out, n_timed)

    net, tokens = policy.network(), out.observations
    T = tokens.shape[-2]
    lstate = net.initial_state((ENVS, AGENTS))
    with torch.no_grad():
        forward_ms = _time_ms(torch, lambda: net(tokens, lstate), 10, queued=True)
        pool_ms = _time_ms(torch, lambda: net.encoder.pool(tokens.view(-1, T, 3)), 10, queued=True)
        generator = torch.Generator(device="cuda")
        generator.manual_seed(33)
        n = len(info.action_names)
        puffer = PufferDefaultNet(n, T * 3, device="cuda", generator=generator)
        pstate = puffer.initial_state((ENVS, AGENTS))
        puffer_ms = _time_ms(torch, lambda: puffer(tokens, pstate), 10, queued=True)
        stateless = StatelessPolicyNet(n, T * 3, device="cuda", generator=generator)
        stateless_ms = _time_ms(torch, lambda: stateless(tokens), 10, queued=True)
    print(f"[33] lstm policy (encoder 192, hidden 128) driving the flagship, {ENVS} envs x {AGENTS} agents "
          f"({ENVS * AGENTS} per forward pass), pool {POOL}, auto-reset, on the engine's device observations: "
          f"{ENVS * n_timed / dt:.1f} env-steps/s, {dt / n_timed * 1e3:.3f} ms/step with the policy; make_step alone "
          f"{ENVS * n_timed / dt_step:.1f} env-steps/s, {dt_step / n_timed * 1e3:.3f} ms/step (host clock over "
          f"{n_timed} steps); B1 launched {launches['obs_tail_static_v2']} times for {want} obs passes; forward pass "
          f"{forward_ms:.3f} ms, of it the encoder's pooling {pool_ms:.3f} ms; puffer (256) {puffer_ms:.3f} ms, "
          f"stateless (128) {stateless_ms:.3f} ms (CUDA events, queued); peak device memory {peak:.2f} GiB on {card}",
          flush=True)
    del puffer, stateless, pstate

    env = MettaGridVectorEnv(make_arena(AGENTS, combat=False), num_envs=ENVS, seed=0)
    numpy_policy = TorchMultiAgentPolicy(info, seed=34)
    env.reset()
    buffers = env.buffers
    for _ in range(4):
        numpy_policy.step_batch(buffers.observations, buffers.actions)
        env.step()
    t0 = time.perf_counter()
    for _ in range(16):
        numpy_policy.step_batch(buffers.observations, buffers.actions)
        env.step()
    dt_env = time.perf_counter() - t0
    assert 0 <= buffers.actions.min() and buffers.actions.max() < len(info.action_names)
    upload_ms = _time_ms(torch, lambda: torch.as_tensor(buffers.observations, device="cuda"), 10)
    env.set_supervisor(TorchMultiAgentPolicy(info, seed=35))
    rng = np.random.default_rng(33)
    for _ in range(2):
        env.step(rng.integers(0, len(info.action_names), env.num_agents).astype(np.int32))
    teacher = buffers.teacher_actions
    assert 0 <= teacher.min() and teacher.max() < len(info.action_names) and len(np.unique(teacher)) > 1
    print(f"[33] the same policy through MettaGridVectorEnv.step_batch on its numpy buffers: "
          f"{ENVS * 16 / dt_env:.1f} env-steps/s, {dt_env / 16 * 1e3:.3f} ms/step (host clock over 16 steps); "
          f"uploading a step's observations ({buffers.observations.nbytes} bytes) {upload_ms:.4f} ms (CUDA events); "
          f"as the env's supervisor: teacher actions in range", flush=True)


def _rooms_config(max_steps: int):
    """Three agents, each in a room of its own."""
    from mettagrid_tpu_torch.config.game_config import GameConfig, MettaGridConfig, WallConfig
    from mettagrid_tpu_torch.maps.ascii import AsciiMapBuilder

    rooms = ["##########", "#@.#.@#..#", "#..#..#.@#", "##########"]
    return MettaGridConfig(game=GameConfig(num_agents=3, max_steps=max_steps, objects={"wall": WallConfig()},
                                           map_builder=AsciiMapBuilder.Config(map_data=rooms)))


def _policy_rollouts(torch, card: str):
    """Phase 34: Rollout, run_multi_episode and replays on the card against
    the CPU; run_episode_local with an lstm policy data file on the card."""
    import tempfile

    from mettagrid_tpu_torch.policy import PolicyEnvInterface, PolicySpec, RandomMultiAgentPolicy
    from mettagrid_tpu_torch.policy import TorchMultiAgentPolicy, load_policy
    from mettagrid_tpu_torch.runner import EpisodeRequest, run_episode_local
    from mettagrid_tpu_torch.simulator import Simulation, SimulatorEventHandler
    from mettagrid_tpu_torch.simulator.multi_episode import run_multi_episode
    from mettagrid_tpu_torch.simulator.replay_writer import InMemoryReplayWriter
    from mettagrid_tpu_torch.simulator.rollout import Rollout

    cfg = _rooms_config(24)
    info = PolicyEnvInterface.from_config(cfg)
    results, replays = {}, {}
    for dev in ("cuda", "cpu"):
        writer = InMemoryReplayWriter()
        results[dev] = Rollout(cfg, RandomMultiAgentPolicy(info, seed=34), seed=34, event_handlers=[writer],
                               device=dev).run()
        replays[dev] = json.loads(json.dumps(writer.get_completed_replays()[0].finalize()))
    gpu, cpu = results["cuda"], results["cpu"]
    assert gpu.steps == cpu.steps == 24
    assert np.array_equal(gpu.episode_rewards, cpu.episode_rewards)
    assert gpu.episode_stats == cpu.episode_stats
    assert replays["cuda"] == replays["cpu"], "the replays differ"
    multi = [run_multi_episode(cfg, [(RandomMultiAgentPolicy(info, seed=35), [0, 1, 2])], 2, seed=35, device=dev)
             for dev in ("cuda", "cpu")]
    assert multi[0].model_dump() == multi[1].model_dump()

    actions = []

    class Record(SimulatorEventHandler):
        def on_step(self) -> None:
            actions.append(self._simulation.state.agent_last_action[0].tolist())

    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/lstm.pkl"
        TorchMultiAgentPolicy(info, seed=36).save_policy_data(path)
        spec = PolicySpec(class_path="lstm", policy_data_path=path)
        result = run_episode_local(EpisodeRequest(config=cfg, policy_specs=[spec], seed=36),
                                   event_handlers=[Record()])
        loaded = load_policy(spec, info, device="cuda")
    assert result.steps == len(actions) == 24 and result.error is None
    assert all(0 <= a < len(info.action_names) for step in actions for a in step)
    tokens = Simulation(cfg, seed=36).last_outputs.observations[0]  # [3, T, 3] on the card
    with torch.no_grad():
        logits, values, _ = loaded.network()(tokens, loaded.network().initial_state((3,)))
    assert torch.isfinite(logits).all() and torch.isfinite(values).all()
    print(f"[34] Rollout (24 steps, 3 agents in rooms of their own) and run_multi_episode (2 episodes) with the "
          f"random policy on the card equal the CPU: steps, rewards, episode stats, decoded replays; "
          f"run_episode_local with an lstm spec from a policy data file on the card: {len(actions)} steps, actions "
          f"in range, finite logits", flush=True)


def _trainer_gpu_vs_cpu(torch, card: str):
    """Phase 35: the trainer on the card against the CPU, from one set of
    weights, with the actions and agent orders fed from numpy, under SGD;
    then the port's Adam alone on gradients copied from the card."""
    from mettagrid_tpu_torch.builder import make_navigation
    from mettagrid_tpu_torch.engine import build_env_init, compile_program, make_reset, make_step
    from mettagrid_tpu_torch.engine.interop import state_to_numpy
    from mettagrid_tpu_torch.parallel import TrainState, adam, make_train_step, trainable_parameters
    from mettagrid_tpu_torch.parallel.train import a2c_loss
    from mettagrid_tpu_torch.policy import LSTMPolicy

    E, A, n_steps = 8, 2, 5
    cfg = make_navigation(A)
    cfg.game.max_steps = 32
    cfg.game.map_builder.width = cfg.game.map_builder.height = 10
    # Seeded, as the weights and the fed draws are: an unseeded builder draws
    # a new map each run, and on some maps a loss passes near 0, where the
    # relative bound below is finer than float32 noise.
    cfg.game.map_builder.seed = 35
    program = compile_program(cfg)
    init = build_env_init(program, [cfg.game.map_builder.create().build_for_num_agents(A)])
    n = len(program.action_names)
    rng = np.random.default_rng(35)
    acts = [rng.integers(0, n, (E, A)).astype(np.int32) for _ in range(n_steps)]
    perms = [np.stack([rng.permutation(A) for _ in range(E)]).astype(np.int32) for _ in range(n_steps)]
    generator = torch.Generator(device="cuda")
    generator.manual_seed(35)
    start = LSTMPolicy(n, 32, 32, device="cuda", generator=generator).state_dict()
    runs = {}
    for dev in ("cuda", "cpu"):
        policy = LSTMPolicy(n, 32, 32, device=dev)
        policy.load_state_dict(start)
        step = make_step(program, init, auto_reset=True, external_perm=True, device=dev)
        perm = {}

        def step_fn(state, actions, vibes, obs_buf=None):
            return step(state, actions, vibes, perm["now"], obs_buf)

        optimizer = torch.optim.SGD(trainable_parameters(policy), lr=0.1)
        train_step = make_train_step(program, step_fn, policy, optimizer)
        state, out = make_reset(program, init, E, device=dev)(0)
        ts = TrainState(state, out.observations, policy.initial_state((E, A)), torch.Generator(device=dev))
        trace = []
        for i in range(n_steps):
            perm["now"] = torch.from_numpy(perms[i]).to(dev)
            ts, metrics = train_step(ts, actions=torch.from_numpy(acts[i]).to(dev))
            trace.append(({k: float(v) for k, v in metrics.items()}, state_to_numpy(ts.env_state),
                          ts.obs.cpu().numpy().copy(), [x.detach().cpu().clone() for x in ts.lstm_state],
                          {k: v.detach().cpu().clone() for k, v in policy.state_dict().items()}))
        runs[dev] = trace
    worst = {"metrics": 0.0, "params": 0.0, "lstm": 0.0}
    for i, (g, c) in enumerate(zip(runs["cuda"], runs["cpu"])):
        for name, value in g[0].items():
            assert np.isfinite(value), f"step {i}: {name} is not finite on the card"
            rel = abs(value - c[0][name]) / max(abs(c[0][name]), 1e-30)
            assert abs(value - c[0][name]) <= 1e-4 * abs(c[0][name]), f"step {i}: {name} {value} vs {c[0][name]}"
            worst["metrics"] = max(worst["metrics"], rel)
        for name in g[1]:
            if name != "rng":
                assert np.array_equal(g[1][name], c[1][name]), f"step {i}: state {name} differs between GPU and CPU"
        assert np.array_equal(g[2], c[2]), f"step {i}: the observations differ between GPU and CPU"
        worst["lstm"] = max(worst["lstm"], *(float((x - y).abs().max()) for x, y in zip(g[3], c[3])))
        worst["params"] = max(worst["params"], *(float((g[4][k] - c[4][k]).abs().max()) for k in g[4]))
    assert worst["lstm"] <= 1e-5 and worst["params"] <= 1e-5, worst
    assert runs["cuda"][-1][4]["cell.bias_ih"].abs().max() == 0

    # The port's Adam alone: one update from the card's gradients, on both.
    policies = {dev: LSTMPolicy(n, 32, 32, device=dev) for dev in ("cuda", "cpu")}
    optimizers = {}
    for dev, policy in policies.items():
        policy.load_state_dict(start)
        policy.cell.bias_ih.requires_grad_(False)
        optimizers[dev] = adam(policy, 1e-3)
    state, out = make_reset(program, init, E, device="cuda")(0)
    logits, values, _ = policies["cuda"](out.observations, policies["cuda"].initial_state((E, A)))
    rewards = torch.from_numpy(rng.standard_normal((E, A)).astype(np.float32)).cuda()
    loss, _ = a2c_loss(logits, values, torch.from_numpy(acts[0]).cuda(), rewards, 0.5, 0.01)
    loss.backward()
    for p_gpu, p_cpu in zip(trainable_parameters(policies["cuda"]), trainable_parameters(policies["cpu"])):
        p_cpu.grad = p_gpu.grad.cpu()
    for opt in optimizers.values():
        opt.step()
    adam_err = max(float((p_gpu.detach().cpu() - p_cpu.detach()).abs().max())
                   for p_gpu, p_cpu in zip(policies["cuda"].parameters(), policies["cpu"].parameters()))
    assert adam_err <= 1e-6, f"the port's Adam differs between GPU and CPU by {adam_err}"
    print(f"[35] trainer on the card equals the CPU over {n_steps} SGD steps of the demo's configuration ({E} envs x "
          f"{A} agents, widths 32, actions and agent orders from numpy): env state and observations byte-equal, "
          f"metrics within {worst['metrics']:.3g} relative (bound 1e-4), parameters within {worst['params']:.3g} and "
          f"LSTM state within {worst['lstm']:.3g} (bound 1e-5); one Adam update from the card's gradients equal within "
          f"{adam_err:.3g} (bound 1e-6) on {card}", flush=True)


def _trainer_path(torch, card: str):
    """Phase 36: make_train_step with adam over LSTMPolicy at its default
    widths on the flagship at full width, timed beside make_step alone, its
    parts apart through train_step's mark hook; then run_performance with
    phase timing on the flagship's make_step."""
    from mettagrid_tpu_torch.engine import make_reset, make_step
    from mettagrid_tpu_torch.parallel import TrainState, adam, make_train_step
    from mettagrid_tpu_torch.perf import run_performance
    from mettagrid_tpu_torch.policy import LSTMPolicy
    from mettagrid_tpu_torch.policy.policy import generators
    from mettagrid_tpu_torch.profiling.phase_timing import span_times
    from mettagrid_tpu_torch.tools.bench_run import AGENTS, ENVS, POOL, WARMUP, BenchRun, build_pool, make_cfg

    n_timed, lr = 16, 1e-3
    bench = BenchRun("flagship", seed=36, envs=ENVS, pool=POOL)
    n = len(bench.program.action_names)
    init_gen, action_gen = generators(36, "cuda")
    policy = LSTMPolicy(n, device="cuda", generator=init_gen)
    optimizer = adam(policy, lr)

    def step_fn(state, actions, vibes, obs_buf=None):
        return bench.step(state, actions, vibes, None, obs_buf)

    train_step = make_train_step(bench.program, step_fn, policy, optimizer)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    state, out = bench.reset(0)
    ts = TrainState(state, out.observations, policy.initial_state((ENVS, AGENTS)), action_gen)
    before = [p.detach().clone() for p in policy.parameters()]
    ts, metrics = train_step(ts)
    first_move = max(float((p.detach() - b).abs().max()) for p, b in zip(policy.parameters(), before))
    assert first_move <= lr * (1 + 1e-4), f"Adam's first update moved a parameter by {first_move} > {lr}"
    losses = [metrics["loss"]]
    for _ in range(WARMUP - 1):
        ts, metrics = train_step(ts)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_timed):
        ts, metrics = train_step(ts)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {name: k.launches for name, (k, _) in _wrappers().items() if k.launches}
    want = 1 + WARMUP + n_timed
    assert launches == {"obs_tail_static_v2": want}, f"the trainer launched {launches} for {want} obs passes"
    assert bool(torch.isfinite(torch.stack(losses)).all()), "a non-finite loss"
    assert not bool(policy.cell.bias_ih.any()), "the LSTM cell's bias_ih moved"
    assert int((ts.env_state.obj_r[:, :AGENTS] != ts.env_state.agent_spawn_r).sum()) > 0, "no agent moved"
    peak = torch.cuda.max_memory_allocated() / 2**30
    assert peak < 20, f"peak device memory {peak:.2f} GiB"
    _, _, dt_step = bench.timed(*bench.run(*bench.reset(1), WARMUP), n_timed)

    # The parts apart, by CUDA events that train_step's mark hook records
    # between them as the trainer issues them, over further train steps.
    reps, parts = 8, ("forward", "env", "backward", "optimizer")
    marks = []
    for _ in range(reps + 1):
        ev = {"start": torch.cuda.Event(enable_timing=True)}
        ev["start"].record()

        def mark(part, ev=ev):
            ev[part] = torch.cuda.Event(enable_timing=True)
            ev[part].record()

        ts, metrics = train_step(ts, mark=mark)
        losses.append(metrics["loss"])
        marks.append(ev)
    torch.cuda.synchronize()
    part_ms = {b: sum(ev[a].elapsed_time(ev[b]) for ev in marks[1:]) / reps
               for a, b in zip(("start",) + parts, parts)}
    tokens, lstate = ts.obs, ts.lstm_state
    forward_ms = _time_ms(torch, lambda: policy(tokens, lstate), 10, queued=True)
    # The backward pass's matmul operations from the shapes: each weight's
    # gradient, and the input's where it needs one (not the histogram's, nor
    # the detached carried h's).
    enc = policy.encoder
    N, He, Hh = ENVS * AGENTS, enc.hidden_size, policy.hidden_size
    bins = enc.feature_embed.num_embeddings + 2 * enc.pos_x_embed.num_embeddings
    backward_ops = 2 * N * (bins * He + 2 * He * He + 2 * He * Hh + 3 * 4 * Hh * Hh + 2 * Hh * (n + 1))
    # The device's busy time over 4 traced train steps.
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            ts, metrics = train_step(ts)
        torch.cuda.synchronize()
    busy_ms = sum(ms for ms, _ in span_times(prof, 4)[1].values())
    print(f"[36] trainer (make_train_step, adam {lr}, LSTMPolicy encoder 192, hidden 128) on the flagship, {ENVS} envs x "
          f"{AGENTS} agents, pool {POOL}, auto-reset: {ENVS * n_timed / dt:.1f} env-steps/s, "
          f"{dt / n_timed * 1e3:.3f} ms per train step; make_step alone {ENVS * n_timed / dt_step:.1f} env-steps/s, "
          f"{dt_step / n_timed * 1e3:.3f} ms/step (host clock over {n_timed} steps); B1 launched "
          f"{launches['obs_tail_static_v2']} times for {want} env steps; forward pass with grad "
          f"{part_ms['forward']:.3f} ms, the draw and the env step {part_ms['env']:.3f} ms, the loss and its backward "
          f"pass {part_ms['backward']:.3f} ms, optimizer.step {part_ms['optimizer']:.3f} ms (CUDA events between the "
          f"parts of train_step as issued, mean of {reps} train steps); "
          f"forward pass with grad queued {forward_ms:.3f} ms; the backward pass's matmuls {backward_ops / 1e9:.2f} "
          f"GFLOP, bound {backward_ops / SCALAR_OPS_PER_S * 1e3:.3f} ms; device busy {busy_ms:.3f} ms per train step "
          f"(torch.profiler, 4 steps), idle share {max(0.0, 1 - busy_ms / (dt / n_timed * 1e3)):.3f} of the untraced "
          f"step; first update moved a parameter by at most "
          f"{first_move:.6g}; losses finite, first {float(losses[0]):.5f}, last {float(losses[-1]):.5f}; peak device "
          f"memory {peak:.2f} GiB on {card}", flush=True)

    program, init = build_pool(make_cfg("flagship"), POOL)
    result = run_performance(make_step(program, init, auto_reset=True, device="cuda"),
                             make_reset(program, init, ENVS, device="cuda"), num_envs=ENVS, num_agents=AGENTS,
                             n_actions=len(program.action_names), label="flagship", max_cv=None,
                             phase_timing=(program, init))
    phases = {k: round(v * 1e3, 4) for k, v in result.extra["phase_timing_s"].items()}
    print(f"[36] perf.run_performance on the flagship's make_step ({result.rounds} rounds of {result.iters_per_round} "
          f"steps): {result.env_steps_per_s:.1f} env-steps/s, CV {result.cv:.4f}, rounds "
          f"{[round(x, 1) for x in result.round_sps]}; measure_step_phases ms per step (device time: step, all its "
          f"kernels and copies; phases, their spans' kernels) {phases} on {card}", flush=True)


def _trainer_demos(torch, card: str):
    """Phase 37: the training demo in a fresh process on the card, and the
    PettingZoo demo on the card."""
    from mettagrid_tpu_torch.demos.demo_pettingzoo import run

    cmd = [sys.executable, "-m", "mettagrid_tpu_torch.demos.demo_train"]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=sys.path[0] or ".")
    assert res.returncode == 0, res.stderr[-2000:]
    line = res.stdout.strip().splitlines()[-1]
    m = re.fullmatch(r"trained 20 steps; first loss (\S+), last loss (\S+)", line)
    assert m and all(np.isfinite(float(x)) for x in m.groups()), line
    totals = run()
    assert len(totals) == 2 and all(np.isfinite(totals))
    print(f"[37] python -m mettagrid_tpu_torch.demos.demo_train on the card in a fresh process: {line!r}; the "
          f"PettingZoo demo on the card: {len(totals)} episodes, totals {totals} on {card}", flush=True)


def _mapgen_path(torch, card: str, phase: int, variant: str, kernel, yardstick: dict):
    """Phases 38 and 39: a MapGen variant of tools/bench_run.py through
    MettaGridVectorEnv at 4096 envs with a pool of 64 maps, auto-reset on,
    random actions from numpy: the route, the kernel's launches from the
    counts at 0 (reset, 8 warm-up and 32 timed steps), finite outputs,
    agents moved, then the kernel against its plain version on the live
    state. ``yardstick`` is the record
    of the same kernel on its earlier cell, printed beside this one."""
    from mettagrid_tpu_torch.envs import MettaGridVectorEnv
    from mettagrid_tpu_torch.tools.bench_run import make_cfg

    cfg = make_cfg(variant)
    E, pool, n_warm, n_timed = 4096, 64, 8, 32
    label = _KERNELS[kernel.__name__][1]
    A = cfg.game.num_agents
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # The maps alone, built as the vector env builds its pool (seed + i).
    t0 = time.perf_counter()
    maps = [cfg.game.map_builder.model_copy(update={"seed": i}).create().build_for_num_agents(A)
            for i in range(pool)]
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    env = MettaGridVectorEnv(cfg, num_envs=E, map_pool=pool, auto_reset=True, seed=0)
    env_s = time.perf_counter() - t0
    distinct = len({env._init.grid[i].tobytes() for i in range(pool)})
    assert distinct == pool, f"{distinct} distinct maps in a pool of {pool}"
    fn = env._step_fn.obs_fn
    assert fn.route == label and fn.tail is kernel, f"{variant} routes to {fn.route}, not {label}"
    H, W = maps[0].grid.shape
    rng = np.random.default_rng(phase)
    acts = [rng.integers(0, len(env.action_names), E * A).astype(np.int32) for _ in range(n_warm + n_timed)]

    _zero_counts()
    env.reset()
    for a in acts[:n_warm]:
        env.step(a)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for a in acts[n_warm:]:
        obs, rew, term, trunc, _ = env.step(a)
    dt = time.perf_counter() - t0
    launches = {name: k.launches for name, (k, _) in _wrappers().items() if k.launches}
    want = 1 + n_warm + n_timed
    assert launches == {kernel.__name__: want}, f"{variant} launched {launches} for {want} obs passes"
    peak = torch.cuda.max_memory_allocated() / 2**30

    state = env.state
    assert np.isfinite(rew).all() and torch.isfinite(state.game_stats).all(), "a NaN output"
    assert torch.isfinite(state.episode_rewards).all() and obs.dtype == np.uint8
    moved = int(((state.obj_r[:, :A] != state.agent_spawn_r) | (state.obj_c[:, :A] != state.agent_spawn_c)).sum())
    assert moved > 0, "no agent moved"
    record = _tail_record(torch, fn, state)
    record["launches"] = launches[kernel.__name__]
    print(f"[{phase}] {variant}: {pool} MapGen maps of {H}x{W} built in {build_s:.3f} s on the host "
          f"({build_s / pool * 1e3:.1f} ms each; the vector env's constructor {env_s:.3f} s, compile and set-up "
          f"included); route {fn.route}; {E} envs x {A} agents through MettaGridVectorEnv: "
          f"{E * n_timed / dt:.1f} env-steps/s, {dt / n_timed * 1e3:.3f} ms/step (host clock over {n_timed} "
          f"steps); {label} launched {record['launches']} times for {want} obs passes, no other kernel; "
          f"{moved} agents off their spawn cell; peak device memory {peak:.2f} GiB on {card}", flush=True)
    print(f"[{phase}] {label} equal to its plain version (normal and wide packing) on the live {variant} state: "
          f"{_times(record)}; {_plan_note(kernel)}; on its earlier cell {yardstick['ms']:.4f} ms "
          f"(bound {yardstick['bound_ms']:.4f} ms)", flush=True)
    return record


def _reference_rng(torch, card: str):
    """Phase 41: the port's host ReferenceRng (the g++-built std::mt19937)
    against the engine's MT19937 twin on the card, exactly."""
    from mettagrid_tpu_torch.engine.mt19937 import mt_init, mt_next, shuffle_perm, uniform_int
    from mettagrid_tpu_torch.parity import ReferenceRng
    from mettagrid_tpu_torch.parity.rng import library_path

    def twin(seeds):
        return mt_init(torch.tensor(seeds, dtype=torch.int64, device="cuda"))

    def every(n):
        return torch.ones(n, dtype=torch.bool, device="cuda")

    t0 = time.perf_counter()
    seeds = [5489, 0, 12345, 2**32 - 1]
    refs = [ReferenceRng(s) for s in seeds]
    assert all(r.native for r in refs), "the native reference RNG did not build"
    state = twin(seeds)
    for i in range(700):
        state, u = mt_next(state, every(4))
        assert u.tolist() == [r.next_u32() for r in refs], f"raw draw {i}"
    ranges = [1, 2, 5, 23, 24, 600, 65535, 10**6]
    refs = [ReferenceRng(s) for s in (7, 99)]
    state = twin([7, 99])
    for hi in ranges:
        for _ in range(20):
            state, x = uniform_int(state, torch.full((2,), hi + 1, dtype=torch.int64, device="cuda"), every(2))
            assert x.tolist() == [r.uniform_int(0, hi) for r in refs], f"uniform_int(0, {hi})"
    for n in (2, 24, 97):
        seeds = [n * 31 + 1, n * 31 + 2]
        refs = [ReferenceRng(s) for s in seeds]
        state, perm = shuffle_perm(twin(seeds), torch.full((2,), n, dtype=torch.int64, device="cuda"), n + 3, every(2))
        for e, ref in enumerate(refs):
            assert perm[e, :n].tolist() == ref.permutation(n), f"shuffle of {n}"
            assert perm[e, n:].tolist() == list(range(n, n + 3))
        state, u = mt_next(state, every(2))
        assert u.tolist() == [r.next_u32() for r in refs], f"the draw after the shuffle of {n}"
    print(f"[41] ReferenceRng (native, {library_path().name}) equals the engine's MT19937 twin on the card: 700 raw "
          f"draws of 4 seeds across the twist, uniform_int over {len(ranges)} ranges x 20 draws, shuffle_perm for n "
          f"in (2, 24, 97) with the next draw; {time.perf_counter() - t0:.1f} s on {card}", flush=True)


def _b1_only(where: str) -> int:
    """B1's launches since the counts were set to 0; asserts it launched and
    no other kernel did."""
    launches = {name: k.launches for name, (k, _) in _wrappers().items()}
    b1 = launches.pop("obs_tail_static_v2")
    assert b1 > 0, f"{where}: B1 never launched"
    others = {k: v for k, v in launches.items() if v}
    assert not others, f"{where}: other kernels launched: {others}"
    return b1


class _LogLines:
    """The lines the port's LogRenderer logs, in order."""

    def __init__(self):
        import logging

        self.lines = []
        handler = logging.Handler(logging.INFO)
        handler.emit = lambda record: self.lines.append(record.getMessage())
        logger = logging.getLogger("mettagrid_tpu_torch.renderer.log_renderer")
        logger.setLevel(logging.INFO)
        logger.propagate = False
        logger.addHandler(handler)


def _sdk_answers(sdk, sim, info, memory, a: int, step: int):
    """build_state, decode_observation, the helper catalog and a memory
    store's retrieval for agent a, as plain values."""
    state = sdk.build_state(sim, a)
    obs = sim.agent(a).observation
    assert all(type(t.value) is int and type(t.location_byte) is int for t in obs.tokens)
    d = sdk.decode_observation(sdk.ObservationEnvelope(obs, info, step))
    cells = [(tuple(c.location), c.tags, c.features) for c in d.cells]
    h = sdk.StateHelperCatalog(state)
    nearest = h.nearest_visible_entity()
    counts = h.visible_entity_counts()
    memory.add(sdk.MemoryRecord(record_id=f"s{step}a{a}", kind="event", tags=sorted(counts), step=step,
                                importance=len(counts) / 10))
    hits = [r.model_dump() for r in memory.retrieve(sdk.MemoryQuery.from_state(state), limit=3)]
    helpers = (h.position(), counts, h.visible_entity_ids(max_distance=3),
               None if nearest is None else nearest.model_dump(),
               [h.distance_to_entity(e.entity_id) for e in state.visible_entities])
    return state.model_dump(), (d.center_row, d.center_col, cells, d.global_features), helpers, hits


def _sdk(torch, card: str):
    """Phase 42: the SDK on a Simulation on the card against one on the CPU
    (the flagship arena, reference_shuffle); the miniscope and log renderers
    ride on both, for phase 44. Returns the renderers' output per device."""
    import io

    import mettagrid_tpu_torch.sdk as sdk
    from mettagrid_tpu_torch.builder import make_arena
    from mettagrid_tpu_torch.policy import PolicyEnvInterface
    from mettagrid_tpu_torch.renderer import LogRenderer, MiniscopeRenderer
    from mettagrid_tpu_torch.simulator import Simulation

    t0 = time.perf_counter()
    cfg = make_arena(24, combat=False)
    cfg.game.max_steps = 24
    info = PolicyEnvInterface.from_config(cfg)
    log = _LogLines()
    out = {dev: {"frames": [], "log": [], "minis": MiniscopeRenderer(fps=0, out=io.StringIO(), use_emoji=False)}
           for dev in ("cuda", "cpu")}
    _zero_counts()
    sims = {}
    for dev in ("cuda", "cpu"):
        mark = len(log.lines)
        sims[dev] = Simulation(cfg, seed=42, reference_shuffle=True, device=dev,
                               event_handlers=[out[dev]["minis"], LogRenderer()])
        out[dev]["log"] += log.lines[mark:]
    gpu, cpu = sims["cuda"], sims["cpu"]
    memories = {dev: sdk.InMemoryMemoryStore() for dev in sims}
    names = gpu.action_names
    rng = np.random.default_rng(42)
    steps = entities = 0
    while True:
        for dev, sim in sims.items():
            out[dev]["frames"].append(out[dev]["minis"].render_frame())
        for a in range(gpu.num_agents):
            g = _sdk_answers(sdk, gpu, info, memories["cuda"], a, steps)
            c = _sdk_answers(sdk, cpu, info, memories["cpu"], a, steps)
            for what, x, y in zip(("build_state", "decode_observation", "helpers", "memory"), g, c):
                assert x == y, f"step {steps}, agent {a}: {what} differs"
            entities += len(g[0]["visible_entities"])
        if gpu.is_done or cpu.is_done:
            break
        for a in range(gpu.num_agents):
            action = names[int(rng.integers(0, len(names)))]
            gpu.agent(a).set_action(action)
            cpu.agent(a).set_action(action)
        for dev, sim in sims.items():
            mark = len(log.lines)
            sim.step()
            out[dev]["log"] += log.lines[mark:]
        steps += 1
    assert gpu.is_done and cpu.is_done and steps == 24
    route = gpu._step_fn.obs_fn.route
    assert route == "B1", route
    b1 = _b1_only("phase 42")
    print(f"[42] the SDK on a Simulation (make_arena(24), reference_shuffle, route {route}) on the card equals the "
          f"CPU over {steps} steps to the episode end, all {gpu.num_agents} agents: build_state (model_dump, "
          f"{entities} visible entities in all), decode_observation, StateHelperCatalog, InMemoryMemoryStore; B1 "
          f"launches {b1}; {time.perf_counter() - t0:.1f} s on {card}", flush=True)
    return out


def _checked(client, twin, ms: list):
    """A client policy whose every request is checked against ``twin``, an
    in-process copy of the served policy; appends each request's host ms to
    ``ms``."""
    from mettagrid_tpu_torch.policy.policy import MultiAgentPolicy

    class Checked(MultiAgentPolicy):
        def reset(self) -> None:
            client.reset()
            twin.reset()

        def step_batch(self, raw_observations, raw_actions) -> None:
            t0 = time.perf_counter()
            client.step_batch(raw_observations, raw_actions)
            ms.append((time.perf_counter() - t0) * 1e3)
            want = np.full_like(raw_actions, -1)
            twin.step_batch(raw_observations, want)
            assert np.array_equal(raw_actions, want), f"request {len(ms)}: the served actions differ"

    return Checked()


def _policy_servers(torch, card: str):
    """Phase 43: the JSON and the protobuf policy servers on 127.0.0.1, each
    serving the lstm policy on the card to a Rollout of the flagship arena
    on the card, every request checked against an in-process twin."""
    from mettagrid_tpu_torch.builder import make_arena
    from mettagrid_tpu_torch.policy import PolicyEnvInterface, TorchMultiAgentPolicy
    from mettagrid_tpu_torch.runner.policy_server import (
        LocalPolicyServer,
        ProtobufPolicyServer,
        ProtobufRemotePolicy,
        RemotePolicy,
    )
    from mettagrid_tpu_torch.simulator.rollout import Rollout

    t0 = time.perf_counter()
    cfg = make_arena(24, combat=False)
    cfg.game.max_steps = 32
    info = PolicyEnvInterface.from_config(cfg)
    notes = []
    for protocol in ("json", "protobuf"):
        served, twin = (TorchMultiAgentPolicy(info, seed=43, device="cuda") for _ in range(2))
        for p, q in zip(served.network().parameters(), twin.network().parameters()):
            assert torch.equal(p, q)
        _zero_counts()
        server = LocalPolicyServer(served) if protocol == "json" else ProtobufPolicyServer(served)
        server.start()
        try:
            if protocol == "json":
                client = RemotePolicy(server.uri)
            else:
                client = ProtobufRemotePolicy(server.uri, info, agent_ids=list(range(24)))
            ms = []
            rollout = Rollout(cfg, _checked(client, twin, ms), seed=43, device="cuda")
            T = rollout.simulation.num_observation_tokens
            result = rollout.run()
            client.close()
        finally:
            server.stop()
        assert result.steps == 32 and len(ms) == 32
        assert np.isfinite(result.episode_rewards).all()
        b1 = _b1_only(f"phase 43, {protocol}")
        notes.append(f"{protocol}: median {float(np.median(ms)):.3f} ms per request (host clock, {len(ms)} "
                     f"requests; min {min(ms):.3f}, max {max(ms):.3f}), B1 launches {b1}")
    print(f"[43] the lstm policy (default widths, seed 43) on the card behind LocalPolicyServer (JSON) and "
          f"ProtobufPolicyServer (sim.policy_v1) on 127.0.0.1, driving a Rollout of make_arena(24) on the card "
          f"through RemotePolicy and ProtobufRemotePolicy, 32 steps of 24 agents x {T} tokens: every request's "
          f"actions equal the in-process twin's; {'; '.join(notes)}; {time.perf_counter() - t0:.1f} s on {card}",
          flush=True)


def _renderers_and_demo(torch, card: str, rendered: dict):
    """Phase 44: the renderers' output from phase 42 on the card against the
    CPU; a replay written by a Rollout on the card through the validator and
    the HTML viewer; the demo in a fresh process; the live viewer serving one
    client."""
    import tempfile
    import zlib

    from mettagrid_tpu_torch.builder import make_arena
    from mettagrid_tpu_torch.policy import PolicyEnvInterface, RandomMultiAgentPolicy
    from mettagrid_tpu_torch.renderer.live_viewer import LiveViewer
    from mettagrid_tpu_torch.renderer.replay_validator import validate_replay
    from mettagrid_tpu_torch.renderer.replay_viewer import write_viewer
    from mettagrid_tpu_torch.simulator import Simulation
    from mettagrid_tpu_torch.simulator.replay_writer import ReplayLogWriter
    from mettagrid_tpu_torch.simulator.rollout import Rollout
    from websockets.sync.client import connect

    t0 = time.perf_counter()
    gpu, cpu = rendered["cuda"], rendered["cpu"]
    assert gpu["frames"] == cpu["frames"], "the miniscope frames differ"
    assert gpu["minis"]._out.getvalue() == cpu["minis"]._out.getvalue(), "the miniscope output differs"
    assert gpu["log"] == cpu["log"] and "=== Episode End ===" in gpu["log"], "the log lines differ"
    cfg = make_arena(24, combat=False)
    cfg.game.max_steps = 24
    _zero_counts()
    with tempfile.TemporaryDirectory() as tmp:
        writer = ReplayLogWriter(tmp)
        info = PolicyEnvInterface.from_config(cfg)
        result = Rollout(cfg, RandomMultiAgentPolicy(info, seed=44), seed=44, event_handlers=[writer],
                         device="cuda").run()
        path = writer.get_written_replay_paths()[0]
        with open(path, "rb") as f:
            replay = json.loads(zlib.decompress(f.read()))
        issues = validate_replay(replay)
        assert result.steps == 24 and issues == [], issues
        html = write_viewer(path, f"{tmp}/replay.html").read_text()
        assert "boot({" in html and len(html) > len(json.dumps(replay, separators=(",", ":")))
    b1 = _b1_only("phase 44")
    cmd = [sys.executable, "-m", "mettagrid_tpu_torch.demo", "--steps=16", "--render"]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=sys.path[0] or ".")
    assert res.returncode == 0, res.stderr[-2000:]
    demo_line = res.stdout.strip().splitlines()[-1]
    assert demo_line.startswith("episode finished: steps=16 "), demo_line
    viewer = LiveViewer(port=0)
    sim = Simulation(cfg, seed=44, event_handlers=[viewer], device="cuda")
    try:
        with connect(viewer.url.replace("http://", "ws://") + "ws", open_timeout=10) as ws:
            init = json.loads(ws.recv(timeout=10))
            assert init["type"] == "init" and init["replay"]["version"] == 4
            sim.step()
            msg = json.loads(ws.recv(timeout=10))
            assert msg["type"] == "step" and msg["step"] == 0 and msg["new_objects"]
    finally:
        sim.close()
        viewer.close()
    print(f"[44] MiniscopeRenderer (ASCII) and LogRenderer on phase 42's Simulations: {len(gpu['frames'])} frames "
          f"and {len(gpu['log'])} log lines on the card equal the CPU's, string for string; a replay written by a "
          f"Rollout on the card (24 steps, B1 launches {b1}) passes validate_replay with no issues and replay_viewer "
          f"wrote its HTML ({len(html)} bytes); python -m mettagrid_tpu_torch.demo --steps=16 --render in a fresh "
          f"process on the card: {demo_line!r}; LiveViewer served one client its first frame and a step over "
          f"127.0.0.1; {time.perf_counter() - t0:.1f} s on {card}", flush=True)


def _host_apis(torch, card: str):
    """Phases 41-44: the reference RNG, the SDK, the policy servers, the
    renderers and the demo on the card."""
    t0 = time.perf_counter()
    _reference_rng(torch, card)
    rendered = _sdk(torch, card)
    _policy_servers(torch, card)
    _renderers_and_demo(torch, card, rendered)
    print(f"[44] phases 41-44 took {time.perf_counter() - t0:.1f} s", flush=True)


def _flagship_trainers(torch, program, init, n: int, mesh=None, sgd_lr: float | None = None):
    """A one-device trainer and, with ``mesh``, a sharded one on the
    flagship at ENVS x AGENTS, from one seeded LSTMPolicy (default widths)
    and adam(1e-3) (SGD at ``sgd_lr`` where given), each with its own
    make_step seeded alike (made with external_perm where there is no
    mesh). Returns [(policy, train_step, ts)] and the generator of the fed
    draws."""
    from mettagrid_tpu_torch.engine import make_reset, make_step
    from mettagrid_tpu_torch.parallel import TrainState, adam, make_train_step, replicate, shard_batch, \
        trainable_parameters
    from mettagrid_tpu_torch.policy import LSTMPolicy
    from mettagrid_tpu_torch.policy.policy import generators
    from mettagrid_tpu_torch.tools.bench_run import AGENTS, ENVS

    init_gen, action_gen = generators(n, "cuda")
    start = LSTMPolicy(len(program.action_names), device="cuda", generator=init_gen).state_dict()
    state, out = make_reset(program, init, ENVS, device="cuda")(0)
    trainers = []
    for m in (None, mesh):
        policy = LSTMPolicy(len(program.action_names), device="cuda")
        policy.load_state_dict(start)
        step = make_step(program, init, auto_reset=True, device="cuda", external_perm=mesh is None)
        ts_state, obs = (state, out.observations.clone()) if m is None else shard_batch((state, out.observations), m)
        if m is not None:
            replicate(policy, m)
        own = torch.Generator(device="cuda")
        own.manual_seed(n + 2)
        ts = TrainState(ts_state, obs, policy.initial_state((obs.shape[0], AGENTS)), own)
        optimizer = adam(policy, 1e-3) if sgd_lr is None else torch.optim.SGD(trainable_parameters(policy), sgd_lr)
        trainers.append((policy, make_train_step(program, step, policy, optimizer, mesh=m), ts))
        if mesh is None:
            break
    return trainers, action_gen


def _draw(torch, policy, ts, generator):
    """The actions the policy draws from ``generator`` on ts's observations."""
    from mettagrid_tpu_torch.policy.policy import sample_actions

    with torch.no_grad():
        return sample_actions(policy(ts.obs, ts.lstm_state)[0], generator)


def _one_rank_nccl(torch, card: str, program, init):
    """Phase 45: the sharded trainer in a one-rank NCCL group, bit-equal to
    the one-device trainer at full width; both timed, and the all-reduce."""
    import torch.distributed as dist

    from mettagrid_tpu_torch.parallel import make_mesh, trainable_parameters
    from mettagrid_tpu_torch.parallel.dryrun import free_port
    from mettagrid_tpu_torch.tools.bench_run import ENVS, WARMUP

    kernel = _wrappers()["obs_tail_static_v2"][0]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0)
    try:
        mesh = make_mesh(1)
        (trainers, gen) = _flagship_trainers(torch, program, init, 45, mesh)
        (p1, one, ts1), (p2, sharded, ts2) = trainers
        n_steps, launches = 1 + WARMUP + 16, 0
        _zero_counts()
        # The encoder's histogram (scatter_add_) sums in no fixed order on the
        # card; PyTorch's deterministic mode gives it a fixed one, so that two
        # runs of one function can agree bit for bit. (It warns that cuBLAS
        # wants CUBLAS_WORKSPACE_CONFIG, which matters only across streams.)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                for i in range(n_steps):
                    acts = _draw(torch, p1, ts1, gen)
                    ts1, m1 = one(ts1, actions=acts)
                    before = kernel.launches
                    ts2, m2 = sharded(ts2, actions=acts)
                    launches += kernel.launches - before
                    assert all(torch.equal(a, b) for a, b in zip(p1.parameters(), p2.parameters())), \
                        f"step {i}: the one-rank trainer's parameters differ from the one-device trainer's"
                    assert all(torch.equal(m1[k], m2[k]) for k in m1), f"step {i}: metrics {m1} vs {m2}"
            finally:
                torch.use_deterministic_algorithms(False)
        for name in ts1.env_state._fields:
            assert torch.equal(getattr(ts1.env_state, name), getattr(ts2.env_state, name)), f"state field {name}"
        assert torch.equal(ts1.obs, ts2.obs) and bool(torch.isfinite(m2["loss"]))
        assert launches == n_steps, f"B1 launched {launches} times for {n_steps} env steps of the sharded trainer"
        _b1_only("phase 45")

        # Both trainers timed in turns, drawing their own actions, after 4
        # warm-up steps each outside the deterministic mode.
        runs = {"one device": [one, ts1], "one rank": [sharded, ts2]}

        def run(name: str, n: int) -> float:
            fn, ts = runs[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                ts, _ = fn(ts)
            torch.cuda.synchronize()
            runs[name][1] = ts
            return (time.perf_counter() - t0) / n * 1e3

        for name in runs:
            run(name, 4)
        times = {k: [] for k in runs}
        for name in ("one device", "one rank", "one rank", "one device"):
            times[name].append(run(name, 16))
        # The reduce part by CUDA events from the mark hook.
        reduce_ms, ts = [], runs["one rank"][1]
        for _ in range(9):
            ev = {}

            def mark(part, ev=ev):
                ev[part] = torch.cuda.Event(enable_timing=True)
                ev[part].record()

            ts, _ = sharded(ts, mark=mark)
            reduce_ms.append(ev)
        torch.cuda.synchronize()
        reduce_ms = sum(ev["backward"].elapsed_time(ev["reduce"]) for ev in reduce_ms[1:]) / 8
        numel = sum(p.numel() for p in trainable_parameters(p2)) + 3
        buf = torch.ones(numel, device="cuda")
        group = mesh.get_group("data")
        allreduce_ms = _time_ms(torch, lambda: dist.all_reduce(buf, group=group), 50, queued=True)
    finally:
        dist.destroy_process_group()
    one_ms, rank_ms = (sum(times[k]) / 2 for k in ("one device", "one rank"))
    print(f"[45] one-rank NCCL group (make_mesh(1), shard_batch, replicate) on the flagship trainer ({ENVS} envs x 24 "
          f"agents, LSTMPolicy default widths, adam 1e-3): every parameter and metric bit-equal to the one-device "
          f"trainer after each of {n_steps} steps fed the same draws, env state and observations equal; B1 launched "
          f"{launches} times for {n_steps} env steps; {rank_ms:.3f} ms per sharded train step against {one_ms:.3f} ms "
          f"one-device (host clock, 2 x 16 steps each in turns: {[round(t, 3) for t in times['one rank']]} vs "
          f"{[round(t, 3) for t in times['one device']]}); the step's reduce part (flatten, all-reduce, division) "
          f"{reduce_ms:.4f} ms (CUDA events, mean of 8 steps); one all-reduce of the flat buffer alone "
          f"{allreduce_ms:.4f} ms queued (one NCCL rank: no device work), {numel} floats = {numel * 4} bytes, on "
          f"{card}", flush=True)


def _two_gloo_ranks(torch, card: str, program, init):
    """Phase 46: two rig ranks sharing the card over Gloo replay a one-device
    training run at full width."""
    import tempfile

    from mettagrid_tpu_torch.engine.interop import state_to_numpy
    from mettagrid_tpu_torch.parallel import rig
    from mettagrid_tpu_torch.parallel.dryrun import fed_draws, spawn_ranks
    from mettagrid_tpu_torch.policy import params_to_flax
    from mettagrid_tpu_torch.tools.bench_run import AGENTS, ENVS, POOL

    # SGD: under Adam, float32 noise in gradients near 0 (sums of 2048 rows
    # and of two ranks against sums of 4096) steers a few components by up
    # to the learning rate a step, so a 1e-5 bound on the parameters holds
    # by luck (two runs on an H100 read 1.07e-6 and 9.38e-6 after 8 Adam
    # steps); SGD moves each by lr times the all-reduced gradient.
    n_steps, lr = 8, 0.1
    (trainers, gen) = _flagship_trainers(torch, program, init, 46, sgd_lr=lr)
    (policy, one, ts), = trainers
    start = (state_to_numpy(ts.env_state), ts.obs.cpu().numpy().copy(), params_to_flax(policy))
    rng = np.random.default_rng(46)
    fed, losses = {"actions": [], "perm": [], "reset_maps": []}, []
    for _ in range(n_steps):
        acts = _draw(torch, policy, ts, gen)
        perm, maps = fed_draws(rng, ENVS, AGENTS, POOL)
        ts, metrics = one(ts, actions=acts, perm=torch.from_numpy(perm).cuda(),
                          reset_maps=torch.from_numpy(maps).cuda())
        for k, v in (("actions", acts.cpu().numpy()), ("perm", perm), ("reset_maps", maps)):
            fed[k].append(v)
        losses.append(float(metrics["loss"]))
    want_state, want_obs = state_to_numpy(ts.env_state), ts.obs.cpu().numpy()
    want_params = np.concatenate([p.detach().cpu().numpy().ravel() for p in policy.parameters()])
    del trainers, ts, policy, one
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        path_in, path_out = f"{tmp}/in.npz", f"{tmp}/out.npz"
        rig.write_replay(path_in, state=start[0], obs=start[1], params=start[2], optimizer="sgd", lr=lr,
                         variant="flagship", **{k: np.stack(v) for k, v in fed.items()})
        t0 = time.perf_counter()
        results = spawn_ranks(2, ["--device", "cuda", "--backend", "gloo", "--replay", path_in, "--out", path_out],
                              timeout=600)
        ranks_s = time.perf_counter() - t0
        for r, res in enumerate(results):
            assert res.returncode == 0 and f"RIG_OK rank={r}" in res.stdout, f"rank {r}:\n{res.stdout[-3000:]}"
        got = rig.read_result(path_out)
    for name, want in want_state.items():
        assert np.array_equal(got["state"][name], want), f"state field {name} differs from the one-device run"
    assert np.array_equal(got["obs"], want_obs), "observations differ from the one-device run"
    # The reference rig's bound (tests/test_multiprocess.py): 1e-5 of the
    # loss, or of 1 where the loss is smaller. A loss is a mean of float32
    # terms of order 0.1-1 that crosses 0 as the value head learns, so sums
    # of 2048 rows and of two ranks differ from sums of 4096 by about 1e-7
    # whatever the loss, which is far more than 1e-5 of a loss near 0.
    loss_err = [abs(s["loss"] - w) for s, w in zip(got["steps"], losses)]
    assert all(e <= 1e-5 * max(1.0, abs(w)) for e, w in zip(loss_err, losses)), \
        f"losses {[s['loss'] for s in got['steps']]} vs {losses}"
    loss_rel = max(e / abs(w) for e, w in zip(loss_err, losses))
    param_diff = np.abs(got["rank_params"] - want_params).max(axis=0)
    param_err = float(param_diff.max())
    assert param_err <= 1e-5, (f"parameters up to {param_err} from the one-device run's, "
                               f"{int((param_diff > 1e-5).sum())} past 1e-5")
    assert got["rank_params"][0].tobytes() == got["rank_params"][1].tobytes(), "the two ranks' parameters differ"
    assert list(got["rank_launches"]) == [n_steps, n_steps], f"B1 launches per rank {got['rank_launches']}"
    peaks = [round(int(b) / 2**30, 2) for b in got["rank_peak_bytes"]]
    print(f"[46] two rig ranks sharing the card over Gloo (--device cuda --backend gloo), {ENVS // 2} envs each of the "
          f"flagship's {ENVS}, replaying {n_steps} steps of a one-device SGD {lr} trainer (LSTMPolicy default widths): "
          f"gathered env state and observations equal, losses within {max(loss_err):.3g} (bound 1e-5 of "
          f"max(1, |loss|); "
          f"{loss_rel:.3g} relative, smallest |loss| {min(abs(w) for w in losses):.4g}), parameters "
          f"within {param_err:.3g} (bound 1e-5), both ranks' parameters bit-equal, B1 launched "
          f"{[int(x) for x in got['rank_launches']]} times; peak device memory per rank {peaks} GiB; the two rank "
          f"processes took {ranks_s:.1f} s (start, imports, build, replay, gather) on {card}", flush=True)


def _dryrun(card: str) -> str:
    """Phase 47: dryrun_multichip(1) on CUDA over NCCL; returns its line."""
    from mettagrid_tpu_torch.parallel.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    out = dryrun_multichip(1)[0]
    losses = [ln for ln in out.splitlines() if ln.startswith("RIG_LOSSES ")]
    assert "RIG_OK rank=0" in out and len(losses) == 1, out[-3000:]
    vals = [float.fromhex(t) for t in losses[0].split()[1:]]
    assert all(np.isfinite(vals))
    return (f"[47] dryrun_multichip(1) on CUDA over NCCL in a fresh process: engine parity across the mesh and two "
            f"sharded train steps (losses {vals}), RIG_OK rank=0; {time.perf_counter() - t0:.1f} s (beside phase 46) "
            f"on {card}")


def _multi_device(torch, card: str):
    """Phases 45-47: the mesh and the sharded trainer on the card."""
    from mettagrid_tpu_torch.tools.bench_run import POOL, build_pool, make_cfg

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    program, init = build_pool(make_cfg("flagship"), POOL)
    _one_rank_nccl(torch, card, program, init)
    torch.cuda.empty_cache()
    # Phase 47's rank process runs while phase 46 does: both mostly wait on
    # processes starting up.
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        dryrun = pool.submit(_dryrun, card)
        _two_gloo_ranks(torch, card, program, init)
        print(dryrun.result(), flush=True)
    print(f"[47] phases 45-47 took {time.perf_counter() - t0:.1f} s", flush=True)


def _parity_data():
    """tests/torch_parity_scenarios.py beside this script (the scenarios and
    families the port's CPU tests hold to the JAX package), loaded by path."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "torch_parity_scenarios.py")
    spec = importlib.util.spec_from_file_location("torch_parity_scenarios", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _parity_runs(device: str) -> dict:
    """Each scenario's run_ours and each family's run_arena_ours on
    ``device``, with the kernels each launched (the counts set to 0 just
    before each run and read just after)."""
    import torch

    from mettagrid_tpu_torch.parity import arena, cross_engine

    if device == "cpu":
        torch.set_num_threads(4)
    data = _parity_data()
    out = {}
    for name, sc in data.SCENARIOS.items():
        out[("scenario", name)] = _launched(lambda: cross_engine.run_ours(sc, device=device))
    for name, (family, steps, (map_seed, action_seed)) in data.ARENA_FAMILIES.items():
        map_data = arena.arena_map(24, map_seed)
        out[("family", name)] = _launched(
            lambda: arena.run_arena_ours(map_data, action_seed, steps, device=device, **family))
    return out


def _launched(run):
    """run() with every launch count at 0 just before it; returns its result
    and {kernel: launches} of the kernels it launched."""
    _zero_counts()
    out = run()
    return out, {name: k.launches for name, (k, _) in _wrappers().items() if k.launches}


def _launch_text(launches: dict) -> str:
    return ", ".join(f"{_KERNELS[k][1]} {n}" for k, n in launches.items())


def _cross_engine_scenarios(gpu: dict, cpu: dict, oracle: bool, launched: dict):
    """Phase 48: each cross-engine scenario's run_ours on the card against
    the CPU's, and against the reference C++ engine where it is built."""
    from mettagrid_tpu_torch.parity import cross_engine

    scenarios = _parity_data().SCENARIOS
    for name, sc in scenarios.items():
        (trace, launches), (ref, cpu_launches) = gpu[("scenario", name)], cpu[("scenario", name)]
        problems = cross_engine.diff_traces(trace, ref)
        assert not problems, f"{name}: " + "\n".join(problems)
        assert trace["route"] == ref["route"] and not cpu_launches
        assert ("obs" in trace["steps"][0]) == sc.compare_obs
        assert launches, f"{name}: no kernel launched on the card"
        if oracle:
            problems = cross_engine.diff_traces(trace, cross_engine.run_reference(sc))
            assert not problems, f"{name} against the C++ engine: " + "\n".join(problems)
        for k, n in launches.items():
            launched.setdefault(k, []).append(("scenario", name, n))
        print(f"[48] {name}: {trace['route']} route, launched {_launch_text(launches)}; the card's trace equals the "
              f"CPU's over {len(sc.scripts)} steps{' with observation tokens' if sc.compare_obs else ''}"
              f"{' and the C++ engine' if oracle else ''}", flush=True)
    print(f"[48] {len(scenarios)} cross-engine scenarios on the card equal the CPU", flush=True)


def _arena_families(card: str, gpu: dict, cpu: dict, oracle: bool, launched: dict):
    """Phase 49: each arena family's run_arena_ours on the card against the
    CPU's at its step count, and run_arena_parity where the oracle is built."""
    from mettagrid_tpu_torch.parity import arena

    families = _parity_data().ARENA_FAMILIES
    for name, (family, steps, (map_seed, action_seed)) in families.items():
        (result, launches), (ref, cpu_launches) = gpu[("family", name)], cpu[("family", name)]
        problems = arena.diff_arena(result, ref, 24)
        assert not problems, f"{name}: " + "\n".join(problems[:20])
        for key in ("actions", "checkpoints", "obs", "final", "route", "signature"):
            assert result[key] == ref[key], f"{name}: {key} differs between the card and the CPU"
        assert launches and not cpu_launches, f"{name}: no kernel launched on the card"
        if oracle:
            problems = arena.run_arena_parity(map_seed, action_seed, steps, device="cuda", **family)
            assert not problems, f"{name} against the C++ engine: " + "\n".join(problems[:20])
        for k, n in launches.items():
            launched.setdefault(k, []).append(("family", name, n))
        print(f"[49] {name} ({steps} steps, map seed {map_seed}, action seed {action_seed}, 24 agents): "
              f"{result['route']} route, launched {_launch_text(launches)}; checkpoints, observations and the final "
              f"summary equal the CPU's, no engagement problem; signature {result['signature']} on both; "
              f"{result['seconds'] / steps * 1e3:.3f} ms per step on the card (one env, host-bound, host clock with "
              f"the checkpoint reads) against {ref['seconds'] / steps * 1e3:.3f} on the CPU, on {card}", flush=True)
    print(f"[49] {len(families)} arena families on the card equal the CPU", flush=True)


def _parity_kernels(torch, card: str, launched: dict) -> dict:
    """Phase 50: each kernel that phases 48-49 launched against its plain
    version on the live state after 24 steps of the first family that
    launched it. Returns {kernel: figures} with the launches of phases
    48-49."""
    from mettagrid_tpu_torch.parity import arena

    families = _parity_data().ARENA_FAMILIES
    figures = {}
    for kname in [k for k in _KERNELS if k in launched]:
        if kname in figures:
            continue
        runs = [r for r in launched[kname] if r[0] == "family"]
        label = _KERNELS[kname][1]
        assert runs, f"{label} launched by the scenarios only"
        name = runs[0][1]
        family, _, (map_seed, action_seed) = families[name]
        sim = arena.arena_simulation(arena.arena_map(24, map_seed), action_seed, 24, "cuda", **family)
        for row in arena.family_script(sim, action_seed, 24, **family):
            for i, action in enumerate(row):
                sim.agent(i).set_action(action)
            sim.step()
        fn = sim._step_fn.obs_fn
        if kname in ("window_slices", "compact_rows"):
            b7, b8, shapes = _nonfused_records(torch, fn, sim.state)
            new = {"window_slices": b7, "compact_rows": b8}
            print(f"[50] B7 and B8 equal to their plain versions on the {name} family's state after 24 steps "
                  f"{shapes}: B7 {_times(b7)}; B8 {_times(b8)} on {card}", flush=True)
        else:
            assert fn.tail.__name__ == kname, f"{name} routes to {fn.tail.__name__}"
            rec = _tail_record(torch, fn, sim.state)
            new = {kname: rec}
            print(f"[50] {label} equal to its plain version on the {name} family's state after 24 steps: "
                  f"{_times(rec)} on {card}", flush=True)
        for k, rec in new.items():
            figures[k] = {"launches": sum(r[2] for r in launched.get(k, [])),
                          **{f: rec[f] for f in ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
    return figures


def _parity_phases(torch, card: str) -> dict:
    """Phases 48-50: the parity runs on the card. Their CPU side runs in
    a process of its own meanwhile."""
    import multiprocessing

    from mettagrid_tpu_torch.parity.reference_oracle import reference_available

    t0 = time.perf_counter()
    oracle = reference_available()
    if not oracle:
        print("[48] the comparison with the reference C++ engine was not run: its oracle "
              "(build/reference/mettagrid_c.so, built by scripts/build_reference_oracle.sh from the reference's "
              "sources at build/reference/src) is not in this checkout; phases 48-49 hold the card to the CPU", flush=True)
    with concurrent.futures.ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as pool:
        cpu_side = pool.submit(_parity_runs, "cpu")
        gpu = _parity_runs("cuda")
        t_gpu = time.perf_counter() - t0
        cpu = cpu_side.result()
    print(f"[48] the card's runs of phases 48-49 took {t_gpu:.1f} s, the CPU's (in a process of its own, "
          f"meanwhile) {time.perf_counter() - t0:.1f} s from the start", flush=True)
    launched: dict = {}
    _cross_engine_scenarios(gpu, cpu, oracle, launched)
    _arena_families(card, gpu, cpu, oracle, launched)
    torch.cuda.empty_cache()
    figures = _parity_kernels(torch, card, launched)
    print(f"[50] phases 48-50 took {time.perf_counter() - t0:.1f} s", flush=True)
    return figures


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from mettagrid_tpu_torch.engine.kernels import build
    except ImportError as exc:
        print(f"chip_smoke: the mettagrid_tpu_torch package is not beside this script ({exc})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # --- phase 1: device ---
    card = _card_line()
    name = torch.cuda.get_device_name(0)
    print(f"[1] device {name}, {torch.cuda.device_count()} visible; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    # --- phase 2: build every kernel from the checkout's sources ---
    t0 = time.perf_counter()
    report = build.build()
    for kname, (secs, log) in report.items():
        ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        instances = sum("Compiling entry function" in ln for ln in log.splitlines())
        spills = [m for m in re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log) if m != ("0", "0")]
        print(f"[2] built {kname} in {secs:.1f} s: {instances} instances, {len(spills)} spilling: "
              f"{'; '.join(ptxas)}", flush=True)
    print(f"[2] build phase {time.perf_counter() - t0:.1f} s", flush=True)
    wrappers = _wrappers()

    b1 = _main_path(torch, card)
    for pool in (1, 3):
        _gpu_vs_cpu(torch, "flagship", pool, 64, 48, 24)
        print(f"[5] GPU path equals the CPU path over 48 steps of 64 envs, pool of {pool} map(s), with "
              "auto-resets (every output, every state field but rng)", flush=True)
    b2 = _general_paths(torch, card)
    for armed in (False, True):
        program, trace = _general_gpu_vs_cpu(torch, armed)
        print(f"[9] GPU path equals the CPU path on the general config{' (armed)' if armed else ''} over 48 "
              "steps of 64 envs, pool of 3 maps, with auto-resets and events (every output, every state field "
              "but rng)", flush=True)

    b4 = _new_route(torch, card, 10, "arena_lp", wrappers["obs_tail_static_v1"][0])
    b5 = _new_route(torch, card, 11, "general_lp", wrappers["obs_tail_v1"][0])
    b3 = _new_route(torch, card, 12, "arena_128", wrappers["obs_tail_dyn_v2"][0])
    torch.cuda.empty_cache()
    for variant, pool, E, n_steps, max_steps in (("arena_lp", 3, 64, 48, 24), ("general_lp", 3, 64, 48, 24),
                                                 ("arena_128", 2, 8, 40, 16)):
        _gpu_vs_cpu(torch, variant, pool, E, n_steps, max_steps)
        print(f"[13] GPU path equals the CPU path on {variant} over {n_steps} steps of {E} envs, pool of {pool} "
              "maps, with auto-resets (every output, every state field but rng)", flush=True)

    b7, b8 = _territory_paths(torch, card)
    torch.cuda.empty_cache()
    for pool in (1, 3):
        _gpu_vs_cpu(torch, "territory", pool, 64, 48, 24)
        print(f"[16] GPU path equals the CPU path on territory over 48 steps of 64 envs, pool of {pool} map(s), "
              "with auto-resets (every output, every state field but rng)", flush=True)
    from mettagrid_tpu_torch.engine.obs import make_stage1

    program, _ = _gpu_vs_cpu(torch, "combat", 3, 64, 24, 16, change=_wide_window)
    S = make_stage1(program).num_slots
    assert program.obs_width * S > 128
    print(f"[16] GPU path equals the CPU path on combat with a 15x15 window (S = {S}, rows of "
          f"{program.obs_width * S} lanes) over 24 steps of 64 envs, pool of 3 maps, with auto-resets", flush=True)

    b6a = _new_route(torch, card, 17, "flagship_v3", wrappers["obs_tail_static_v3"][0])
    b6b = _new_route(torch, card, 18, "arena_mood_v3", wrappers["obs_tail_dyn_v3"][0], check=_walls_changed_vibe)
    _tithe_path(torch, card)
    torch.cuda.empty_cache()
    for variant, rrng in (("flagship_v3", None), ("arena_mood_v3", None), ("tithe_rrng", None),
                          ("arena_mood_v3", True)):
        program, trace = _gpu_vs_cpu(torch, variant, 3, 64, 48, 24, reference_rng=rrng)
        rrng_note = " under reference_rng" if rrng or variant.endswith("_rrng") else ""
        print(f"[20] GPU path equals the CPU path on {variant}{rrng_note} over 48 steps of 64 envs, pool of 3 maps, "
              "with auto-resets (every output, every state field but rng, mt included)", flush=True)

    _synthetic_tails(torch)
    _per_env_tails(torch)
    _b3_b6a_tails(torch)
    _launch_limits(torch)
    fc = _full_combat(torch, card)
    b7["full_combat"], b8["full_combat"] = fc["B7"], fc["B8"]
    _synthetic_windows(torch)
    t_net = time.perf_counter()
    b2["network"] = _network(torch, card)
    _network_gpu_vs_cpu(torch)
    print(f"[28] phases 27-28 took {time.perf_counter() - t_net:.1f} s", flush=True)
    t_api = time.perf_counter()
    _vector_env(torch, card)
    _episode_ends(torch, card)
    _simulation(torch, card)
    print(f"[31] phases 29-31 took {time.perf_counter() - t_api:.1f} s", flush=True)
    t_policy = time.perf_counter()
    _policy_nets(torch, card)
    _policy_path(torch, card)
    _policy_rollouts(torch, card)
    print(f"[34] phases 32-34 took {time.perf_counter() - t_policy:.1f} s", flush=True)
    t_train = time.perf_counter()
    _trainer_gpu_vs_cpu(torch, card)
    _trainer_path(torch, card)
    _trainer_demos(torch, card)
    print(f"[37] phases 35-37 took {time.perf_counter() - t_train:.1f} s", flush=True)
    from mettagrid_tpu_torch.tools.bench_run import make_cfg

    t_mapgen = time.perf_counter()
    b1["assembly_lines"] = _mapgen_path(torch, card, 38, "assembly_lines", wrappers["obs_tail_static_v2"][0], b1)
    b3["bsp_arena"] = _mapgen_path(torch, card, 39, "bsp_arena", wrappers["obs_tail_dyn_v2"][0], b3)
    torch.cuda.empty_cache()
    _gpu_vs_cpu(torch, "assembly_lines", 3, 64, 48, 24, cfg=make_cfg("assembly_lines", num_agents=4))
    print("[40] GPU path equals the CPU path on assembly_lines (4 agents, MapGen maps) over 48 steps of 64 envs, "
          "pool of 3 maps, with auto-resets (every output, every state field but rng)", flush=True)
    print(f"[40] phases 38-40 took {time.perf_counter() - t_mapgen:.1f} s", flush=True)
    _host_apis(torch, card)
    _multi_device(torch, card)
    records = dict(zip(_KERNELS, (b1, b2, b3, b4, b5, b6a, b6b, b7, b8)))
    for kname, figures in _parity_phases(torch, card).items():
        records[kname]["parity"] = figures
    print(f"[50] all phases passed in {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card)
    print(json.dumps({"kernels": [b1, b2, b3, b4, b5, b6a, b6b, b7, b8]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
