"""Drive the PyTorch port on one CUDA card, check it, and time its kernel.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits nonzero without
printing a result:

1. require CUDA and print the card (name, power limit);
2. build every kernel from ``minigrid_tpu_torch/csrc`` (one ``nvcc`` per
   source, all started together) and print the build seconds;
3. hold each kernel bitwise against its plain PyTorch version on the card:
   the egocentric-window gather over every direction x pose on random grids,
   and on DoorKey-8x8 states at B=4096 after a random walk (with the whole
   observation checked against the CPU) and at the ragged B=4097 (a last
   tile of one env), each with a self-check that the compare catches a
   single flipped bit; the fused step on DoorKey-8x8 at B=4096 after a
   random walk (every action, some agents carrying the key), on a batch
   whose small ``max_steps`` sends most lanes to regeneration, on the same
   at the ragged B=4097, on Empty-5x5 (the view runs past the grid; half the
   agents face the goal), Empty-Random-6x6 and Empty-16x16, every output
   compared (grid, agent plane, image, reward bits, flags, next key, step
   index), plus the flipped-bit self-check on the image and on the grid of
   the first and the ragged batch; the threefry kernel against the plain
   ``core/rng.py`` formula on the CPU: ``split`` into 2, 3, 5 and 37 keys at
   B in {1, 16, 4096}, of contiguous keys, of keys cut from a wider split
   and of keys whose two words lie apart, ``bits`` of shapes (), (30,),
   (484,) and (4096, 7) with and without ``rows``, ``fold_in`` by an int and
   by broadcast lanes, keys of all-zero and all-one words, empty batches,
   each with the launches it must make, and the flipped-bit self-check; the
   distractors kernel through ``add_distractors`` against the plain loop on
   the CPU, one launch a call: GoTo's 3x3 rooms of 8 and a 2x3 lattice of
   rooms of 4 that fill, at B in {1, 5, 33, 4097}, with duplicates, unique
   until the combos run out, a fixed column, a row, ``enabled`` and
   ``color_override`` per env, a fixed color while disabled, init_rooms'
   expanded grid and strided keys, a column-major grid, and the
   flipped-bit self-check; the descriptor kernel through ``_rand_objs``
   against the plain loop on the CPU, one launch a call: every LevelGen
   preset at 16 levels on two seeds and at B=4097, BossLevel at 1 level,
   with every object taken off the grid (every lane spends its 24 redraws)
   and with a column-major grid, and the flipped-bit self-check;
4. drive each main path with every kernel's launch count zeroed just before
   and read just after: ``make_vec("MiniGrid-DoorKey-8x8-v0", 4096,
   reset_strategy="pooled", pool_refill=64)`` through the bench loop of
   ``minigrid_tpu_torch.tools.bench`` (bulk refill every 8 steps) past the
   first truncation wave, then the same program at B=16 on the card and on
   the CPU, which must agree bitwise step by step and in the final state;
   then ``make_vec("BabyAI-GoTo-v0", 4096)``, each of three steps exactly
   20 threefry launches and one distractors launch (its 16-level refill's
   draws), and every distractors launch of a B=4096 GoTo and BossLevel
   reset and three refills bitwise the plain loop on the CPU; then
   ``make_vec("BabyAI-BossLevel-v0", 4096)``, each of three steps exactly
   39 threefry launches and one descriptor launch, and every descriptor
   launch of its reset and refills bitwise the plain loop on the CPU;
   then ``FusedVectorEnv(make("MiniGrid-DoorKey-8x8-v0"), 4096)`` for 648
   steps (one ``fused_step`` launch a step, one ``obs_gather`` launch at
   reset, every env regenerated at least once), and the same fused program
   at B=16 on the card and on the CPU, bitwise;

   then the zoo: one id of each single-room family through
   ``make_vec(id, 4096)`` with the reset strategy and refill window the
   family picks (checked against the JAX package's choice), driven 16
   steps at the preset ``max_steps`` and 16 at ``max_steps=16`` with the
   launch counts zeroed before each (one ``obs_gather`` launch per
   observation, none of ``fused_step``), the ranges of image, direction,
   mission and reward checked; the gather bitwise against its plain version
   on each family's states (MultiRoom's 25x25 batch and a ragged B=4097 one
   with the flipped-bit self-check); card == CPU at B=16 for 32 steps; each
   family's env-steps/s with predrawn actions; MultiRoom-N6 at short
   episodes pooled against ``conditional``; ``rollout(refill_period=8)``
   on MultiRoom-N6; the gather's time at 25x25 against its bound; and the
   launches per step of LavaGap and MultiRoom under ``torch.profiler``;

   then the multi-room families: one id of each (UnlockPickup,
   BlockedUnlockPickup, Unlock, KeyCorridorS6R3, ObstructedMaze-Full on the
   RoomGrid builder, pooled with 64-level windows; LockedRoom and
   Playground, fused) through ``make_vec(id, 4096)`` at the strategy the
   JAX package picks, 16 steps at the preset ``max_steps`` and 32 at 16
   with the launch counts zeroed before each (the ring's fresh fraction
   reported), the gather bitwise on each family's states and on
   KeyCorridorS3R1's 7x3 grid (narrower than the view) at the ragged
   B=4097, card == CPU at B=16 for 24 steps, each family's env-steps/s,
   and the launches per step of KeyCorridorS6R3 and ObstructedMaze-Full
   under ``torch.profiler``;

   then BabyAI: six levels (GoToRedBall, GoTo's 22x22 maze, GoToImpUnlock,
   OpenDoorsOrderN4, PickupDistDebug, GoToObjS4's 4x4) through
   ``make_vec(id, 4096)``, pooled at the JAX package's windows with the
   best-effort refill, a walk of 8 steps at ``max_steps`` 4 with the launch
   counts zeroed before it (one ``obs_gather`` launch per observation, none
   of ``fused_step``; the ring's fresh fraction), the gather bitwise on each
   level's states and on OpenRedDoor's 9x5 at B=4097, card == CPU at B=64
   pooled for 8 steps (verifier state included; GoToObjS4 at its
   per-episode ``max_steps`` of 16), env-steps/s at the preset limits (best
   of 2 x 16 steps), and the launches of one step of GoToRedBall and GoTo
   under ``torch.profiler``;

   then (phase 4e) the level generator and the rest of BabyAI, and the
   dataset envs: BossLevel (22x22), SynthS5R2 (13x9, a locked room without
   implicit unlocking), PutNextS7N4Carrying (13x7, the carried start),
   KeyInBox (the key in a box), MoveTwoAcrossS8N9 (15x8, two PutNext clauses
   in sequence), OneRoomS20 (20x20), pooled at the JAX package's windows
   with the best-effort refill, and the five dataset envs, fused, through
   ``make_vec(id, 4096)``: a walk of 8 steps (BabyAI at ``max_steps`` 4)
   with the launch counts zeroed before it, the gather bitwise on its
   states with the flipped-bit self-check, card == CPU at B=64 for 8
   steps, env-steps/s (best of 2 x 16 steps); the gather at Directions'
   3x3 with V=3 and at OneRoomS20's 20x20 on the ragged B=4097; BossLevel's
   launches per step over one step under ``torch.profiler``;

   then (phase 4f) the wrappers and the renderer: DoorKey-8x8 under
   ``RGBImgPartialObsWrapper`` (tile 8, HWC and channels first) and
   ``RGBImgObsWrapper``, DoorKey-16x16 under ``ViewSizeWrapper`` at 3 and
   11, ``ActionBonus`` over DoorKey-8x8 and ``StateBonus`` over MultiRoom-N6
   (pooled), each through ``VectorEnv`` at B=4096 with the JAX package's
   strategy, an 8-step walk with the launch counts zeroed before it (two
   ``obs_gather`` launches an observation where the wrapper gathers a second
   window, else one; none of ``fused_step``), and card == CPU at B=64 for 8
   steps of 4-step episodes (observations, reward bits within 2 ulp, flags,
   the final state with its count tables); the other ten wrappers card ==
   CPU the same way (``ReseedWrapper`` through four resets); the POV render
   (both layouts) and the full render (highlight on and off) bitwise card
   against CPU on a ragged B=4097 with the flipped-pixel self-check,
   ``get_frame`` at 32 pixels; env-steps/s of the RGB walks beside the
   symbolic one, the atlas gather's time against its bound,
   ``tools/benchmark`` on LavaGapS7 and a ``tools/battery`` row with
   ``obs=rgb_chw``;

   then (phase 4g) the learner: a PPO update on DoorKey-8x8, a
   ``RecurrentPPO`` update on MemoryS7 (both B=8, T=16, 2 x 2) and 10 steps
   of ``bc_train``, float32 networks, on the card and on the CPU from one
   key with TF32 off (rollouts equal; values, metrics and parameters within
   the CPU tests' tolerances); PPO at ``examples/train_ppo.py``'s width
   (B=1024, T=128, 4 epochs x 8 minibatches, the default bf16
   ``ActorCritic``) for 3 updates timed by phase (rollout, GAE, optimize)
   with the launch counts zeroed before each (2 ``obs_gather`` launches a
   rollout step, none of ``fused_step``; 32 optimizer steps an update; no
   host sync inside the second), env-steps/s through the loop, peak
   memory, and a fourth update under ``torch.profiler`` for the device's
   idle share; one pooled update on BabyAI-GoToRedBallGrey (B=1024, T=32,
   refill period 8; the ring's tick T); one ``RecurrentPPO`` update at
   ``examples/train_rnn_ppo.py``'s config (B=512, T=256, 4 x 4); and
   ``bc_train`` at ``BCConfig``'s defaults on 1024 x 8 pairs of a rollout
   of the trained policy (its loss must fall), then ``evaluate_policy``;

   then (phase 4h) the multi-device layer, on ranks spawned by
   ``parallel/multihost.spawn``: two ranks share the card under gloo (NCCL
   refuses two ranks on one card) and run ``ShardedVectorEnv`` on
   DoorKey-8x8 at B=4096 (2 x 2048) pooled 64/8 for 64 steps of 16-step
   episodes, every step's rows and the final state bitwise the unsharded
   card run's, ``obs_gather`` launched on every rank every step (counted
   per rank); ``sharded_rollout``'s totals against the unsharded
   ``rollout``; ``dp=2`` PPO at ``examples/train_ppo.py``'s width (update 1
   against the unsharded update 1: 99 % of the actions equal, entropy
   within 1 %, metrics equal on every rank; update 2 timed by phase; the
   gradient all-reduce timed in a third; peak memory per rank); the small
   float32 update over ``dp=1 x tp=2`` against the unsharded one at the
   card == CPU tolerances; then one rank on an NCCL group runs PPO at the
   same width with no host sync in its second update beyond the per-epoch
   count reads (asserted under ``torch.cuda.set_sync_debug_mode``), and
   ``tools/bench_sharded`` runs with the one rank the card holds;

   then (phase 4i) the host surface: which optional packages import
   (gymnasium, matplotlib, PIL, imageio); ``reset_exact`` on the card for
   every supported id (167: the registry less the four dataset envs, which
   must raise) at seeds 0 and 1, its host replay and its device half timed
   apart, one ``obs_gather`` launch a reset, state and observation bitwise
   the CPU's; exact-seed episodes through
   ``gym.make("minigrid_tpu_torch/<id>", exact_seed=True)`` (DoorKey-8x8
   and GoToLocal 64 steps, BossLevel 32) on the card and on the CPU, every
   observation, mission, reward's bits, flag and ``hash`` equal,
   ``obs_gather`` once per reset and step, a step's launches (traced), host
   syncs and median time on both devices, a pickle round trip on the card
   (without gymnasium, the same walks through ``reset_exact`` and
   ``Env.step``); and ``tools/train_ppo`` at 64 envs x 16 steps, 2 updates
   with ``--checkpoint`` then ``--resume`` and 1 more against 3 straight
   (the loaded runner bitwise the saved one, the env state equal, parameters
   and metrics within phase 4g's tolerances);

   then (phase 4j) the host tools, with the launch counts zeroed before each
   part: the BFS oracle's demos (ContrastiveTrajectory 6, Negated-Simple 8,
   seed 0) on the card against ``collect`` on the CPU, every observation
   equal and one ``obs_gather`` launch per reset and step, ``pack_demos``
   through ``torch.save``; ``tools/profile.profile_rollout`` at the main
   configuration for 64 steps with a chrome trace, the gather kernel among
   its kernels once per observation; ``tools/autotune`` on DoorKey-8x8 at
   B=4096 over 16-step rollouts, all 17 candidates measured; the quick
   ``tools/battery_sweep`` into a file seeded with every module but four,
   the gate first; ``tools/gen_docs.build_pages`` with a frame of every
   family, six families' PNGs and a GIF card == CPU byte for byte, and
   ``tools/gen_site.build_site`` over the pages; ``ManualControl`` with a
   fake window, every frame card == CPU; ``tools/smoke.run_smoke``;
5. time each kernel, its plain version and, where one PyTorch call computes
   the same function, that call (CUDA events over CUDA-graph replays,
   median), compute each kernel's bound (the gather also on the 25x25,
   16x16, 19x19, 22x22, 4x4 and 9x5 states of phase 4, OneRoomS20's 20x20
   and Directions' 3x3 at V=3), time the fused step
   at B=32768
   beside B=4096 with its bound, the threefry kernel and its plain formula
   at the GoTo generator's shapes (a 16 x 5 split, 16 x 30 and 4096 x 484
   uniform bits) with the bound and the host time a call takes to issue,
   the distractors kernel and its plain loop on GoTo's call at 16 and 4096
   levels with the bound and the host time of a call, the descriptor
   kernel and its plain loop on BossLevel's call at 16 and 4096 levels
   likewise, and time both engines end to end with the
   actions of each run drawn before its timer starts.

It prints one JSON line of kernel records, then the card line as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives it,
and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

from minigrid_tpu_torch.utils import trace

ENV_ID = "MiniGrid-DoorKey-8x8-v0"
NUM_ENVS = 4096
POOL_REFILL = 64
REFILL_PERIOD = 8
MAIN_STEPS = 648  # past DoorKey-8x8's 640-step truncation, a multiple of 8
VIEW = 7
RAGGED_ENVS = NUM_ENVS + 1  # the last tile of the kernels holds one env
WIDE_ENVS = 32768
SWEEP_SHAPES = ((8, 8, 7), (9, 5, 7), (6, 9, 5))

# the zoo: one id per family, with the reset strategy and refill window the
# JAX package picks for it at B=4096 (VectorEnv: pooled for desynchronized
# resets from 64 envs, conditional for expensive generation, else fused;
# pool_refill the largest divisor of 2B not above B * pool_refill_fraction)
ZOO = (
    ("MiniGrid-LavaGapS7-v0", "fused", 256),
    ("MiniGrid-DistShift1-v0", "fused", 256),
    ("MiniGrid-FourRooms-v0", "fused", 256),
    ("MiniGrid-RedBlueDoors-8x8-v0", "fused", 256),
    ("MiniGrid-MemoryS17Random-v0", "fused", 256),
    ("MiniGrid-Fetch-8x8-N3-v0", "fused", 256),
    ("MiniGrid-GoToDoor-8x8-v0", "fused", 256),
    ("MiniGrid-GoToObject-8x8-N2-v0", "fused", 256),
    ("MiniGrid-PutNear-8x8-N3-v0", "fused", 256),
    ("MiniGrid-LavaCrossingS11N5-v0", "fused", 256),
    ("MiniGrid-Dynamic-Obstacles-16x16-v0", "fused", 256),
    ("MiniGrid-MultiRoom-N6-v0", "pooled", 32),
)
# each walk; 128 before the multi-room phase was added, 32 before the
# level generator's phase (4e)
ZOO_STEPS = 16
ZOO_SHORT_EPISODE = 16  # max_steps of the second walk
ZOO_TIMED_STEPS = 16  # best of 2 (zoo, multi-room); 32 before phase 4e
ZOO_ROLLOUT_STEPS = 64
MULTIROOM = "MiniGrid-MultiRoom-N6-v0"

# the multi-room families, one id each, with the strategy and window the JAX
# package picks at B=4096: the RoomGrid families (expensive generation,
# desynchronized resets, refill fraction 1/64) pooled with 64-level windows,
# LockedRoom and Playground (plain generators) fused
ROOMGRID = (
    ("MiniGrid-UnlockPickup-v0", "pooled", 64),
    ("MiniGrid-BlockedUnlockPickup-v0", "pooled", 64),
    ("MiniGrid-Unlock-v0", "pooled", 64),
    ("MiniGrid-KeyCorridorS6R3-v0", "pooled", 64),
    ("MiniGrid-ObstructedMaze-Full-v0", "pooled", 64),
    ("MiniGrid-LockedRoom-v0", "fused", 256),
    ("MiniGrid-Playground-v0", "fused", 256),
)
# at the preset max_steps (100 to 3,600); 32 before phase 4e
ROOMGRID_STEPS = 16
# at ZOO_SHORT_EPISODE: two waves; 64 (four) before phase 4e
ROOMGRID_SHORT_STEPS = 32
ROOMGRID_CPU_STEPS = 24
ROOMGRID_PROFILED = ("MiniGrid-KeyCorridorS6R3-v0", "MiniGrid-ObstructedMaze-Full-v0")
ROOMGRID_PROFILE_STEPS = 4  # each traced step is 6,000-11,000 launches
NARROW = "MiniGrid-KeyCorridorS3R1-v0"  # 7x3: narrower than the 7x7 view

# BabyAI, with the strategy and window the JAX package picks at B=4096: every
# level pooled (desynchronized resets), refill windows of B/8 for a single
# room and the floor of 16 for the mazes, refilled best-effort through
# generate_attempt
BABYAI = (
    ("BabyAI-GoToRedBall-v0", "pooled", 512),  # one room of 8
    ("BabyAI-GoTo-v0", "pooled", 16),  # 3x3 rooms of 8: 22x22
    ("BabyAI-GoToImpUnlock-v0", "pooled", 16),  # a locked room, exclude_room
    ("BabyAI-OpenDoorsOrderN4-v0", "pooled", 16),  # before/after sequencing
    ("BabyAI-PickupDistDebug-v0", "pooled", 512),  # strict: the failure path
    ("BabyAI-GoToObjS4-v0", "pooled", 512),  # 4x4; per-episode max_steps 16
)
# the walk, at BABYAI_EPISODE: four waves turn the ring over (a walk of 32
# steps at 8 took the phase to 332 s on an H100 80GB HBM3 at 700 W, GoTo's
# 22x22 maze 126 s of it)
# 8 steps (two waves) since phase 4e; 16 before, and 32 at max_steps 8 before that
BABYAI_STEPS = 8
BABYAI_EPISODE = 4
BABYAI_CPU_ENVS = 64  # pooled, best-effort refill
BABYAI_CPU_STEPS = 8  # 24 before phase 4e
BABYAI_TIMED_STEPS = 16  # best of 2; 32 before phase 4e
BABYAI_PROFILED = ("BabyAI-GoToRedBall-v0", "BabyAI-GoTo-v0")
BABYAI_PROFILE_STEPS = 1  # 4 before phase 4e
BABYAI_9X5 = "BabyAI-OpenRedDoor-v0"

# phase 4e: the level generator's, PutNext's, Unlock's and the other BabyAI
# levels, and the five dataset envs, with the strategy and window the JAX
# package picks at B=4096 (the dataset envs are plain Envs: fused)
SLICE_B = (
    ("BabyAI-BossLevel-v0", "pooled", 16),  # LevelGen on 3x3 rooms of 8: 22x22
    ("BabyAI-SynthS5R2-v0", "pooled", 16),  # 13x9, implicit_unlock=False, locked room
    ("BabyAI-PutNextS7N4Carrying-v0", "pooled", 16),  # 13x7, the carried start
    ("BabyAI-KeyInBox-v0", "pooled", 16),  # box planes: the key in a box
    ("BabyAI-MoveTwoAcrossS8N9-v0", "pooled", 16),  # 15x8, two PutNext in sequence
    ("BabyAI-OneRoomS20-v0", "pooled", 512),  # 20x20, one room
    ("ContrastiveDataset-v0", "fused", 256),
    ("ContrastiveTrajectoryDataset-v0", "fused", 256),  # pickups pay +1 or -1
    ("MiniGrid-Negated-Simple-v0", "fused", 256),  # pickups pay +1 or -1
    ("DirectionsDataset-v0", "fused", 256),  # 3x3 at V=3, scripted turns
    ("BlocksDataset-v0", "fused", 256),  # scripted moves from the state's stream
)
SLICE_B_STEPS = 8  # the walk: two waves at SLICE_B_EPISODE (BabyAI)
SLICE_B_EPISODE = 4
SLICE_B_CPU_STEPS = 8
SLICE_B_TIMED_STEPS = 16  # best of 2; 32 before phase 4i (BossLevel's 0.85 s steps)
SLICE_B_PROFILED = "BabyAI-BossLevel-v0"
# a traced step of BossLevel is 54,451 launches; the summary of the trace
# takes about 30 s a step on the card's host (2 steps before phase 4f)
SLICE_B_PROFILE_STEPS = 1
DIRECTIONS = "DirectionsDataset-v0"  # 3x3, V=3: the smallest grid and view
ONE_ROOM_20 = "BabyAI-OneRoomS20-v0"
# the ids whose rewards go below 0
NEGATIVE_REWARDS = ("Dynamic-Obstacles", "ContrastiveTrajectory", "Negated")

# phase 4f: the wrappers and the renderer.  Each walk at B=4096: (name, id,
# wrapper, its kwargs, the strategy and window the JAX package picks, the
# obs_gather launches one observation makes: two where the wrapper gathers a
# second window, for the POV, the highlight or another view size)
DOORKEY_16 = "MiniGrid-DoorKey-16x16-v0"
FETCH = "MiniGrid-Fetch-8x8-N3-v0"  # a mission table of many codes
WRAPPED = (
    ("RGB partial HWC", ENV_ID, "RGBImgPartialObsWrapper", {}, "fused", 256, 2),
    ("RGB partial CHW", ENV_ID, "RGBImgPartialObsWrapper", {"channels_first": True},
     "fused", 256, 2),
    ("RGB full", ENV_ID, "RGBImgObsWrapper", {}, "fused", 256, 2),
    ("view 3", DOORKEY_16, "ViewSizeWrapper", {"agent_view_size": 3}, "fused", 256, 2),
    ("view 11", DOORKEY_16, "ViewSizeWrapper", {"agent_view_size": 11}, "fused", 256, 2),
    ("ActionBonus", ENV_ID, "ActionBonus", {}, "fused", 256, 1),
    ("StateBonus", MULTIROOM, "StateBonus", {}, "pooled", 32, 1),
)
# the other wrappers, card == CPU only (ReseedWrapper through its reset)
OTHER_WRAPPED = (
    ("ImgObsWrapper", ENV_ID, {}),
    ("OneHotPartialObsWrapper", ENV_ID, {}),
    ("FullyObsWrapper", ENV_ID, {}),
    ("SymbolicObsWrapper", ENV_ID, {}),
    ("DirectionObsWrapper", ENV_ID, {}),
    ("DirectionObsWrapper", ENV_ID, {"type": "angle"}),
    ("DictObservationSpaceWrapper", FETCH, {}),
    ("FlatObsWrapper", FETCH, {}),
    ("EasyModeWrapper", ENV_ID, {}),
    ("NoLanguageWrapper", ENV_ID, {}),
)
WRAPPED_STEPS = 8
WRAPPED_CPU_ENVS = 64
WRAPPED_CPU_EPISODE = 4  # max_steps of the card == CPU runs: two waves of resets
WRAPPED_TIMED_STEPS = 32  # best of 2
# float leaves whose card and CPU values may differ in the last bits: the
# bonus 1/sqrt(n) and arctan (both are reported)
FLOAT_ULP = 2
TILE = 8  # RGBImg*Wrapper's default

# phase 4g: the learner.  PPO at examples/train_ppo.py's width on DoorKey-8x8
# with the default bf16 ActorCritic (1,850,201 parameters at V=7)
LEARNER = dict(num_envs=1024, num_steps=128, update_epochs=4, num_minibatches=8)
LEARNER_UPDATES = 3  # timed, the first left out of the rate; a fourth is traced
LEARNER_PARAMS = 1_850_201
# the card == CPU runs, at the CPU tests' size (tests/test_torch_rl_*.py)
LEARNER_SMALL = dict(num_envs=8, num_steps=16, num_updates=2, update_epochs=2,
                     num_minibatches=2)
LEARNER_SMALL_LIMIT = 10  # DoorKey-8x8 at 10 steps: truncations in a 16-step rollout
RNN_SMALL_LIMIT = 6  # MemoryS7 at 6 steps: the carry clears mid-rollout
BC_SMALL_STEPS = 10
POOLED_LEARNER = "BabyAI-GoToRedBallGrey-v0"  # tests/test_rl.py's pooled id
POOLED_LEARNER_CFG = dict(num_envs=1024, num_steps=32, refill_period=8)
RNN_LEARNER = "MiniGrid-MemoryS7-v0"  # examples/train_rnn_ppo.py's config
RNN_LEARNER_CFG = dict(num_envs=512, num_steps=256, num_updates=150, update_epochs=4,
                       num_minibatches=4, lr=1e-3, ent_coef=0.05, gamma=0.95)
BC_ENVS, BC_STEPS = 1024, 8  # (obs, action) pairs of the BC dataset
BC_EVAL_EPISODES, BC_EVAL_STEPS = 2, 16
# card == CPU tolerances, the CPU tests' (tests/test_torch_rl_ppo.py): values
# and log-probs; metrics (relative); each parameter within a tenth of one
# step's lr, each within 1 % (L2) of how far the update moved it
LEARNER_VALUE_ATOL = 1e-5
LEARNER_METRIC_RTOL = 1e-4
LEARNER_PARAM_REL_L2 = 1e-2

# phase 4h: the multi-device layer on one card.  Two ranks share it under
# gloo (NCCL refuses two ranks on one card); one NCCL rank runs once.
MESH_RANKS = 2
MESH_STEPS = 64  # the ShardedVectorEnv walk, pooled POOL_REFILL/REFILL_PERIOD
MESH_EPISODE = 16  # its max_steps: four waves of auto-resets in the walk
MESH_UPDATES = 2  # dp=2 PPO at LEARNER: the first held against the unsharded, the second timed
# the dp=2 bf16 update against the unsharded one: the draw is exact, but a
# rank's bf16 logits over 512 rows may round apart from the unsharded 1024
# rows' (bf16 logits lie within 2.1e-3 of the float32 ones), so a Gumbel-max
# near a tie can flip and the trajectories part there; the float32 tp run
# carries exactness
MESH_ACTION_AGREEMENT = 0.99  # least fraction of equal actions in update 1
MESH_ENTROPY_RTOL = 1e-2  # update 1's entropy against the unsharded
MESH_BENCH_STEPS = 64  # tools/bench_sharded, one rank

# phase 4i: the host surface.  reset_exact on every supported id at each
# seed (the four dataset envs draw from the unseeded global random modules
# upstream, so seed parity is undefined for them), exact-seed GymEnv
# episodes through gym.make, and tools/train_ppo broken by a checkpoint
EXACT_UNSUPPORTED = ("BlocksDataset-v0", "ContrastiveDataset-v0",
                     "ContrastiveTrajectoryDataset-v0", "DirectionsDataset-v0")
EXACT_SUPPORTED = 167  # the 171 registered ids less the four above
EXACT_SEEDS = (0, 1)
OPTIONAL_PACKAGES = ("gymnasium", "matplotlib", "PIL", "imageio")
GYM_EPISODES = (("MiniGrid-DoorKey-8x8-v0", 64), ("BabyAI-GoToLocal-v0", 64),
                ("BabyAI-BossLevel-v0", 32))  # (id, steps), exact_seed=True
GYM_SEED = 11  # the resets' seed and the actions' numpy seed
GYM_TIMED_STEPS = 32  # per device, after the episode
RESUME_ENVS, RESUME_STEPS = 64, 16  # tools/train_ppo's --num-envs, --num-steps
RESUME_SPLIT = (2, 1)  # updates before and after the checkpoint, against their sum straight

# phase 4j: the host tools.  The oracle's demos card == CPU (id, demos asked
# for; seed 0), profile and autotune at the main configuration, the sweep's
# quick rows, gen_docs' frames and GIF (two MiniGrid, two BabyAI, two dataset
# families), ManualControl's keys, run_smoke
HOST_DEMOS = (("ContrastiveTrajectoryDataset-v0", 6), ("MiniGrid-Negated-Simple-v0", 8))
PROFILE_STEPS = 64
AUTOTUNE_STEPS = 16  # a multiple of every candidate's refill period
SWEEP_MODULES = ("empty", "doorkey", "babyai_goto", "rgb_partial")
DOC_FAMILIES = ("EmptyEnv", "DoorKeyEnv", "GoToRedBallGrey", "BossLevel",
                "BlocksDataset", "NegatedSimple")
GIF_FRAMES = 12
MANUAL_KEYS = ("up", "up", "right", "up", "left", " ", "backspace")

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and int32 operations/s
# outside the tensor cores (half the 67 TFLOP/s float32 rate: 64 INT32 lanes
# per SM against 128 FP32).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12

# the threefry kernel: a hash is 20 rounds of add, rotate and xor plus 5 key
# injections, about 80 integer operations (as fused_bound_ms counts it)
HASH_OPS = 80
GOTO = "BabyAI-GoTo-v0"
BOSS = "BabyAI-BossLevel-v0"
# one VectorEnv.step: the 16-level refill's draws outside the distractors,
# whose 18 placements (180 hashes before) are one distractors launch
GOTO_HASHES_PER_STEP = 20
GOTO_DISTRACTOR_LAUNCHES_PER_STEP = 1
# the distractors kernel's useful hashes an object: the 5-way split, 4 a
# randint (the combo, the room's column and row) or the combo's 30 words
# (all_unique), the cell's key and its randint
DISTRACTOR_HASHES = {False: 5 + 4 + 4 + 4 + 1 + 4, True: 5 + 30 + 4 + 4 + 1 + 4}
DISTRACTORS_TIMED = (16, NUM_ENVS)  # GoTo's refill and reset, 18 objects a level
# every LevelGen preset: grids of 8x8 to 22x22, with and without locations,
# implicit unlocking and a locked room
LEVELGEN_IDS = ("BabyAI-BossLevel-v0", "BabyAI-BossLevelNoUnlock-v0", "BabyAI-Synth-v0",
                "BabyAI-SynthS5R2-v0", "BabyAI-SynthLoc-v0", "BabyAI-SynthSeq-v0",
                "BabyAI-MiniBossLevel-v0", "BabyAI-GoToSeq-v0", "BabyAI-PickupLoc-v0")
# one BossLevel VectorEnv.step: its 16-level refill's draws outside the
# descriptor loop and the distractors, whose loops are a launch each
BOSS_HASHES_PER_STEP = 39
BOSS_DESCS_PER_STEP = 1
DESCS_TIMED = (16, NUM_ENVS)  # BossLevel's refill and reset
# (name, keys, counters a key, the call) timed in phase 5: the GoTo
# generator's 5-way split of 16 keys and uniform draws of 16 x 30 and 4096 x 484
THREEFRY_TIMED = (("split 16x5", 16, 5, "split"), ("bits of uniform 16x30", 16, 30, "bits"),
                  ("bits of uniform 4096x484", 4096, 484, "bits"))
HOST_CALLS = 2000  # calls a host-time reading averages over


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def mismatches(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"shape/dtype differ: {a.shape} {a.dtype} vs "
                             f"{b.shape} {b.dtype}")
    return int((a != b).sum())


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def gpu_time_ms(fn, per_graph: int = 20, reps: int = 60) -> float:
    """Device time of one ``fn()`` call: ``per_graph`` calls captured in a
    CUDA graph, each replay timed with CUDA events; median over ``reps``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_graph)
    return statistics.median(times)


# -- phase 3: kernel against plain ----------------------------------------------

def check_gather_sweep(dev, obs_gather) -> int:
    """Every direction x pose on random grids, for each (W, H, V); returns
    the largest |kernel - plain| (0 when bitwise equal)."""
    worst = 0
    gen = torch.Generator().manual_seed(0)
    for w, h, v in SWEEP_SHAPES:
        combos = [(x, y, d) for x in range(w) for y in range(h) for d in range(4)]
        pos = torch.tensor([(x, y) for x, y, _ in combos], dtype=torch.int32)
        dirs = torch.tensor([d for *_, d in combos], dtype=torch.int32)
        n = len(combos)
        cells = torch.stack([torch.randint(0, 34, (n, w, h), generator=gen),
                             torch.randint(0, 11, (n, w, h), generator=gen),
                             torch.randint(0, 3, (n, w, h), generator=gen)], -1)
        grid = (cells[..., 0] | cells[..., 1] << 8 | cells[..., 2] << 16).to(torch.int32)
        grid, pos, dirs = grid.to(dev), pos.to(dev), dirs.to(dev)
        got = obs_gather.gather_view(grid, pos, dirs, v)
        want = obs_gather.gather_view_plain(grid, pos, dirs, v)
        torch.cuda.synchronize()
        bad = mismatches(got, want)
        if bad:
            raise AssertionError(f"obs_gather kernel != plain for W,H,V={w},{h},{v}:"
                                 f" {bad} cells")
        worst = max(worst, max_abs_err(got, want))
        log(f"  sweep W={w} H={h} V={v}: {n} poses, bitwise equal")
    return worst


def doorkey_walk_states(dev, num_envs: int, steps: int = 24, env_id: str = ENV_ID,
                        seed: int = 20260820, **overrides):
    """DoorKey-8x8 levels (or ``env_id``'s) after a random walk (agents
    scattered over every direction, some carrying the key), on ``dev``."""
    import minigrid_tpu_torch
    from minigrid_tpu_torch.core import rng

    env = minigrid_tpu_torch.make(env_id, **overrides)
    params = env.default_params
    key = rng.PRNGKey(seed, dev)
    k_gen, k_act = rng.split(key).unbind(0)
    state = env.generate(rng.split(k_gen, num_envs), params, dev)
    for k in rng.split(k_act, steps):
        action = rng.randint(k, (num_envs,), 0, env.num_actions)
        state = env.step_state(state, action, params)[0]
    return env, params, state


def check_flipped_bit(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    """Self-check: the compare must see a single flipped bit, here in the
    last env's last entry (the ragged tile's) and at one inside."""
    for index in (got.numel() - 1, 12345 % got.numel()):
        flipped = got.clone()
        flipped.view(-1)[index] ^= 1
        if mismatches(flipped, want) != 1:
            raise AssertionError(f"the compare missed a flipped bit in {what}")


def _key_words(gen: torch.Generator, *lead: int) -> torch.Tensor:
    return torch.randint(0, 2**32, lead + (2,), generator=gen, dtype=torch.int64)


def threefry_cases() -> list:
    """(what, keys on the CPU, the draw, the kernel launches it makes): the
    generators' split widths and non-contiguous keys, bit draws with and
    without ``rows``, ``fold_in`` by an int and by broadcast lanes, keys of
    all-zero and all-one words, an empty batch."""
    from minigrid_tpu_torch.core import rng

    gen = torch.Generator().manual_seed(20260820)
    cases = []
    for b in (1, 16, NUM_ENVS):
        keys = _key_words(gen, b)
        for num in (2, 3, 5, 37):
            cases.append((f"split(keys, {num}) B={b}", keys,
                          lambda k, num=num: rng.split(k, num), 1))
        cases.append((f"split of split(keys, 5).unbind(1)[3] B={b}", keys,
                      lambda k: rng.split(rng.split(k, 5).unbind(1)[3], 3), 2))
    one, few = _key_words(gen), _key_words(gen, 16)
    for shape in ((), (30,), (484,)):
        cases.append((f"bits(keys, {shape}) B=16", few, lambda k, s=shape: rng.bits(k, s), 1))
    cases.append(("bits(key, (4096, 7))", one, lambda k: rng.bits(k, (4096, 7)), 1))
    for rows in ((0, 1000), (1000, 2024), (4095, 4096)):
        cases.append((f"bits(key, (4096, 7), rows={rows})", one,
                      lambda k, r=rows: rng.bits(k, (4096, 7), r), 1))
    cases.append((f"bits of split(keys).unbind(-2)[1], (484,) B={NUM_ENVS}",
                  _key_words(gen, NUM_ENVS),
                  lambda k: rng.bits(rng.split(k).unbind(-2)[1], (484,)), 2))
    for data in (0, 1, 2**31, 2**32 - 1):
        cases.append((f"fold_in(keys, {data}) B=16", few, lambda k, d=data: rng.fold_in(k, d), 1))
    cases.append(("fold_in(keys[:, None], lanes[8]) B=16", few,
                  lambda k: rng.fold_in(k[:, None], torch.arange(8, device=k.device)), 1))
    cases.append(("fold_in(split(keys, 5)[:, 2][:, None], lanes[8]) B=16", few,
                  lambda k: rng.fold_in(rng.split(k, 5)[:, 2][:, None],
                                        torch.arange(8, device=k.device)), 2))
    extreme = torch.tensor([[0, 0], [2**32 - 1, 2**32 - 1], [0, 2**32 - 1], [2**32 - 1, 0]])
    cases.append(("split(keys whose two words lie 16 apart, 5) B=16", few,
                  lambda k: rng.split(k.T.contiguous().T, 5), 1))
    cases.append(("split(extreme words, 5)", extreme, lambda k: rng.split(k, 5), 1))
    cases.append(("bits(extreme words, (30,))", extreme, lambda k: rng.bits(k, (30,)), 1))
    cases.append(("fold_in(extreme words, lanes)", extreme,
                  lambda k: rng.fold_in(k, torch.arange(4, device=k.device) * 2**30), 1))
    cases.append(("split of an empty batch", _key_words(gen, 0), lambda k: rng.split(k, 3), 0))
    cases.append(("randint of an empty batch", _key_words(gen, 0),
                  lambda k: rng.randint(k, (), 0, 5), 0))
    cases.append((f"randint(keys, (), 0, 9) B={NUM_ENVS}", _key_words(gen, NUM_ENVS),
                  lambda k: rng.randint(k, (), 0, 9), 2))
    cases.append((f"uniform(keys, (484,)) B={NUM_ENVS}", _key_words(gen, NUM_ENVS),
                  lambda k: rng.uniform(k, (484,)), 1))
    return cases


def check_threefry_kernel(dev) -> int:
    """Phase 3: every case of :func:`threefry_cases` on the card against the
    plain formula on the CPU, bitwise, with the launches each should make;
    the flipped-bit self-check on the widest word output.  Returns the largest
    |kernel - plain| (0 when bitwise equal)."""
    worst, widest = 0, None
    for what, keys, draw, launches in threefry_cases():
        before = trace.launches("threefry")
        got = draw(keys.to(dev))
        torch.cuda.synchronize()
        made = trace.launches("threefry") - before
        want = draw(keys)
        got = got.cpu()
        bad = mismatches(got, want)
        if bad:
            raise AssertionError(f"threefry kernel != plain for {what}: {bad} entries")
        if made != launches:
            raise AssertionError(f"{what}: {made} threefry launches, expected {launches}")
        worst = max(worst, max_abs_err(got, want))
        if got.dtype == torch.int64 and (widest is None or got.numel() > widest[0].numel()):
            widest = (got, want, what)
        log(f"  threefry {what}: {tuple(got.shape)} bitwise equal, {made} launch(es)")
    check_flipped_bit(*widest)
    return worst


def check_goto_hashes(dev) -> dict:
    """The main path's hashes: one ``VectorEnv.step`` of GoTo at B=4096
    (pooled, its 16-level best-effort refill) adds exactly
    GOTO_HASHES_PER_STEP threefry launches and
    GOTO_DISTRACTOR_LAUNCHES_PER_STEP distractors launches, on three
    steps."""
    import minigrid_tpu_torch
    from minigrid_tpu_torch.core import rng

    venv = minigrid_tpu_torch.make_vec(GOTO, NUM_ENVS, device=dev)
    if venv.pool_refill != 16:
        raise AssertionError(f"{GOTO}: pool_refill {venv.pool_refill}, the count assumes 16")
    before = kernel_counts()
    _, state = venv.reset(rng.PRNGKey(4, dev))
    torch.cuda.synchronize()
    reset = kernel_counts(before)
    per_step = []
    for k in rng.split(rng.PRNGKey(5, dev), 3):
        action = rng.randint(k, (NUM_ENVS,), 0, venv.env.num_actions)
        torch.cuda.synchronize()
        before = kernel_counts()
        _, state, *_ = venv.step(state, action)
        torch.cuda.synchronize()
        per_step.append(kernel_counts(before))
    want = (GOTO_HASHES_PER_STEP, GOTO_DISTRACTOR_LAUNCHES_PER_STEP)
    if per_step != [want] * 3:
        raise AssertionError(f"{GOTO} B={NUM_ENVS}: (threefry, distractors) launches a "
                             f"step {per_step}, expected {want}")
    log(f"  {GOTO} B={NUM_ENVS}: {reset[0]} threefry and {reset[1]} distractors launches "
        f"at reset, {per_step} a step")
    return {"reset": reset[0], "per_step": [t for t, _ in per_step],
            "distractors_reset": reset[1], "distractors_per_step": [d for _, d in per_step]}


def kernel_counts(since: tuple = (0, 0)) -> tuple[int, int]:
    """(threefry, distractors) launches since the counts ``since``."""
    return (trace.launches("threefry") - since[0], trace.launches("distractors") - since[1])


def _builder_on(b: dict, dev) -> dict:
    return {k: v.to(dev) for k, v in b.items()}


def distractor_cases() -> list:
    """(what, env, builder, keys, kwargs) on the CPU: every argument form of
    ``add_distractors``' sequential path.  GoTo's builder (3x3 rooms of 8,
    after its doors) at ragged batches and at B=4096 with GoTo's own call;
    a 2x3 lattice of rooms of 4 whose rooms fill (``ok`` False) and whose
    combos run out under ``all_unique``; a fixed column with the row drawn
    and a row per env with the column drawn; ``enabled`` and
    ``color_override`` as Python values and per env (sentinels and a color
    past 255 included); init_rooms' expanded grid, connect_all's rows of a
    wider scatter and a column-major grid; keys cut from a wider split."""
    import minigrid_tpu_torch
    from minigrid_tpu_torch.core import rng
    from minigrid_tpu_torch.core.roomgrid import RoomGridEnv

    gen = torch.Generator().manual_seed(20261018)
    goto = minigrid_tpu_torch.make(GOTO)
    small = RoomGridEnv(room_size=4, num_rows=2, num_cols=3)
    cases = []
    for env, place_agent in ((goto, goto.place_agent_any),
                             (small, lambda b, k, p: small.place_agent_in_room(b, k, p, 1, 1))):
        p = env.default_params
        for n in (1, 5, 33, NUM_ENVS + 1):
            k = rng.split(_key_words(gen, n), 5).unbind(1)
            fresh = env.init_rooms(k[0], p)
            b = env.connect_all(place_agent(fresh, k[1], p), k[2])
            on = torch.rand(n, generator=gen) < 0.7
            col = torch.tensor([-1, 3, 7, 300, 10])[torch.randint(0, 5, (n,), generator=gen)]
            rows = torch.randint(0, env.num_rows, (n,), generator=gen, dtype=torch.int32)
            name = f"{type(env).__name__} B={n}"
            cases += [
                (f"{name} 18, duplicates", env, b, k[3], dict(num_distractors=18,
                                                                all_unique=False)),
                (f"{name} 36 unique: the combos run out", env, b, k[4],
                 dict(num_distractors=36)),
                (f"{name} fixed column 1", env, b, k[3], dict(i=1, num_distractors=9)),
                (f"{name} row per env, enabled and color per env", env, b, k[4],
                 dict(j=rows, num_distractors=7, enabled=on, color_override=col)),
                (f"{name} color 4, disabled", env, b, k[3],
                 dict(num_distractors=5, all_unique=False, color_override=4,
                      enabled=False)),
                (f"{name} the expanded grid, strided keys", env, fresh,
                 rng.split(k[4], 3)[:, 1], dict(num_distractors=4)),
                (f"{name} a column-major grid", env,
                 {**b, "grid": b["grid"].transpose(1, 2).contiguous().transpose(1, 2)},
                 k[3], dict(num_distractors=6)),
            ]
    return cases


def _distractor_outputs(out) -> list:
    b, added, positions = out
    return [b["grid"], b["obj_mask"], added, positions]


def check_distractors_kernel(dev) -> int:
    """Phase 3: every case of :func:`distractor_cases` through
    ``add_distractors`` on the card (one launch of the kernel each) against
    the plain loop on the CPU, bitwise: grid, combo mask, added pairs,
    positions, and every other builder field passed through; the
    flipped-bit self-check on the widest grid.  Returns the largest
    |kernel - plain| (0 when bitwise equal)."""
    worst, widest = 0, None
    for what, env, b, keys, kwargs in distractor_cases():
        p = env.default_params
        before = trace.launches("distractors")
        got = env.add_distractors(_builder_on(b, dev), keys.to(dev), p, **{
            k: v.to(dev) if isinstance(v, torch.Tensor) else v for k, v in kwargs.items()})
        torch.cuda.synchronize()
        made = trace.launches("distractors") - before
        want = env.add_distractors(b, keys, p, **kwargs)
        if made != 1:
            raise AssertionError(f"distractors {what}: {made} launches, expected 1")
        for name, g, w in zip(("grid", "obj_mask", "added", "positions"),
                              _distractor_outputs(got), _distractor_outputs(want)):
            g = g.cpu()
            bad = mismatches(g, w)
            if bad:
                raise AssertionError(f"distractors kernel != plain for {what}: {name} "
                                     f"{bad} entries")
            worst = max(worst, max_abs_err(g, w))
        for k in b:
            if k not in ("grid", "obj_mask") and mismatches(got[0][k].cpu(), want[0][k]):
                raise AssertionError(f"distractors {what}: {k} did not pass through")
        if widest is None or want[0]["grid"].numel() > widest[1].numel():
            widest = (got[0]["grid"].cpu(), want[0]["grid"], what)
        placed = int(want[0]["obj_mask"].sum() - b["obj_mask"].sum())
        log(f"  distractors {what}: bitwise equal, 1 launch, {placed} combos set")
    check_flipped_bit(*widest)
    return worst


def check_distractor_levels(dev) -> dict:
    """Phase 4: every sequential ``add_distractors`` call of a B=4096 GoTo
    and BossLevel reset and of their 16-level refills (three steps each),
    on the card through the kernel, held bitwise against the plain loop on
    the CPU from copies of the same inputs.  Returns the calls held per
    level."""
    import minigrid_tpu_torch
    from minigrid_tpu_torch.core import rng
    from minigrid_tpu_torch.core.roomgrid import RoomGridEnv

    calls: list = []
    orig = RoomGridEnv.add_distractors

    def recorded(self, b, keys, params, *args, **kwargs):
        before = trace.launches("distractors")
        out = orig(self, b, keys, params, *args, **kwargs)
        if trace.launches("distractors") != before:
            calls.append((self, {k: v.cpu() for k, v in b.items()}, keys.cpu(), params,
                          args, {k: v.cpu() if isinstance(v, torch.Tensor) else v
                                 for k, v in kwargs.items()},
                          [t.cpu() for t in _distractor_outputs(out)]))
        return out

    held = {}
    RoomGridEnv.add_distractors = recorded
    try:
        for env_id, seed in ((GOTO, 40), (BOSS, 41)):
            calls.clear()
            venv = minigrid_tpu_torch.make_vec(env_id, NUM_ENVS, device=dev)
            _, state = venv.reset(rng.PRNGKey(seed, dev))
            for k in rng.split(rng.PRNGKey(seed + 100, dev), 3):
                action = rng.randint(k, (NUM_ENVS,), 0, venv.env.num_actions)
                _, state, *_ = venv.step(state, action)
            torch.cuda.synchronize()
            for env, b, keys, params, args, kwargs, got in calls:
                want = _distractor_outputs(orig(env, b, keys, params, *args, **kwargs))
                for name, g, w in zip(("grid", "obj_mask", "added", "positions"), got, want):
                    bad = mismatches(g, w)
                    if bad:
                        raise AssertionError(f"{env_id}: a distractors call of {keys.shape[0]} "
                                             f"levels, {name} differs in {bad} entries")
            held[env_id] = [c[2].shape[0] for c in calls]
            log(f"  {env_id} B={NUM_ENVS}: {len(calls)} distractors calls bitwise the plain "
                f"loop (levels a call: {held[env_id]})")
    finally:
        RoomGridEnv.add_distractors = orig
    if not all(held.values()):
        raise AssertionError(f"a level set ran no distractors kernel: {held}")
    return held


# -- the descriptor kernel ---------------------------------------------------------

def descs_inputs(env, keys: torch.Tensor) -> tuple:
    """``gen_level``'s arguments to ``_rand_objs`` for the levels of
    ``keys``, on their device: (key_d1, key_d2, builder, params,
    locked_rect, has_locked, clause kinds)."""
    from minigrid_tpu_torch.core import rng

    p = env.default_params
    k = rng.split(keys, 16).unbind(1)
    b, has_locked, locked_rect = env._layout(k, p)
    kinds = env._rand_action_kind(rng.fold_in(k[10][:, None],
                                              torch.arange(4, device=keys.device)))
    return k[11], k[12], b, p, locked_rect, has_locked, kinds


def _descs_on(inputs: tuple, dev) -> tuple:
    k1, k2, b, p, rect, locked, kinds = inputs
    return (k1.to(dev), k2.to(dev), _builder_on(b, dev), p, rect.to(dev), locked.to(dev),
            kinds.to(dev))


def descs_cases(dev) -> list:
    """(what, env, inputs on ``dev``): ``_rand_objs``' arguments as
    ``gen_level`` makes them for every LevelGen preset (LEVELGEN_IDS) at 16
    levels on two seeds and at RAGGED_ENVS on one, BossLevel's at 1 level;
    BossLevel's 16 with every object taken off the grid, so that every lane
    spends its fuel, and with a column-major grid."""
    import minigrid_tpu_torch
    from minigrid_tpu_torch.core import constants as C
    from minigrid_tpu_torch.core import rng

    cases = []
    for i, env_id in enumerate(LEVELGEN_IDS):
        env = minigrid_tpu_torch.make(env_id)
        for n, seed in ((16, 2 * i), (16, 2 * i + 1), (RAGGED_ENVS, 100 + i)):
            keys = rng.split(rng.PRNGKey(seed, dev), n)
            cases.append((f"{env_id} B={n} seed {seed}", env, descs_inputs(env, keys)))
    boss = minigrid_tpu_torch.make(BOSS)
    cases.append((f"{BOSS} B=1", boss, descs_inputs(boss, rng.split(rng.PRNGKey(7, dev), 1))))
    k1, k2, b, p, rect, locked, kinds = descs_inputs(boss, rng.split(rng.PRNGKey(8, dev), 16))
    kind = b["grid"] & 0xFF
    objects = sum(kind == C.OBJECT_TO_IDX[t] for t in ("key", "ball", "box", "door"))
    bare = torch.where(objects.bool(), C.OBJECT_TO_IDX["empty"], b["grid"])
    cases.append((f"{BOSS} B=16 without objects: every lane spends its fuel", boss,
                  (k1, k2, {**b, "grid": bare}, p, rect, locked, kinds)))
    column_major = b["grid"].transpose(1, 2).contiguous().transpose(1, 2)
    cases.append((f"{BOSS} B=16 a column-major grid", boss,
                  (k1, k2, {**b, "grid": column_major}, p, rect, locked, kinds)))
    return cases


def check_descs_kernel(dev) -> int:
    """Phase 3: every case of :func:`descs_cases` through ``_rand_objs`` on
    the card (one launch of the descriptor kernel each) against the plain
    loop on the CPU from copies of its inputs, bitwise: d1, d2 and the
    redraws; some lane spends its fuel; the flipped-bit self-check on the
    widest d1.  Returns the largest |kernel - plain| (0 when bitwise
    equal)."""
    from minigrid_tpu_torch.babyai.levelgen import DESC_FUEL

    cpu = torch.device("cpu")
    worst, widest, spent = 0, None, 0
    for what, env, inputs in descs_cases(dev):
        before = trace.launches("descs")
        got = env._rand_objs(*inputs)
        torch.cuda.synchronize()
        made = trace.launches("descs") - before
        want = env._rand_objs_plain(*_descs_on(inputs, cpu))
        if made != 1:
            raise AssertionError(f"descs {what}: {made} launches, expected 1")
        for name, g, w in zip(("d1", "d2", "redraws"), got, want):
            g = g.cpu()
            bad = mismatches(g, w)
            if bad:
                raise AssertionError(f"descs kernel != plain for {what}: {name} {bad} entries")
            worst = max(worst, max_abs_err(g, w))
        redraws = want[2]
        spent += int((redraws == DESC_FUEL).sum())
        if "without objects" in what and not bool((redraws == DESC_FUEL).all()):
            raise AssertionError(f"descs {what}: a lane matched an empty grid")
        if widest is None or want[0].numel() > widest[1].numel():
            widest = (got[0].cpu(), want[0], what)
        log(f"  descs {what}: bitwise equal, 1 launch, redraws max {int(redraws.max())} "
            f"sum {int(redraws.sum())}")
    if not spent:
        raise AssertionError("no lane spent its fuel")
    check_flipped_bit(*widest)
    return worst


def check_boss_descs(dev) -> dict:
    """Phase 4: ``make_vec(BOSS, NUM_ENVS)`` on the card, its reset and
    three steps: every ``_rand_objs`` call (the reset's levels, each step's
    16-level refill) held bitwise against the plain loop on the CPU from
    copies of its inputs, and each step exactly BOSS_DESCS_PER_STEP
    descriptor launches and BOSS_HASHES_PER_STEP threefry launches.
    Returns the launches and the levels a call."""
    import minigrid_tpu_torch
    from minigrid_tpu_torch.babyai.levelgen import LevelGen
    from minigrid_tpu_torch.core import rng

    calls: list = []
    orig = LevelGen._rand_objs

    def recorded(self, *inputs):
        out = orig(self, *inputs)
        calls.append((self, _descs_on(inputs, torch.device("cpu")), [t.cpu() for t in out]))
        return out

    def counts() -> tuple[int, int]:
        return trace.launches("threefry"), trace.launches("descs")

    LevelGen._rand_objs = recorded
    try:
        venv = minigrid_tpu_torch.make_vec(BOSS, NUM_ENVS, device=dev)
        if venv.pool_refill != 16:
            raise AssertionError(f"{BOSS}: pool_refill {venv.pool_refill}, the count assumes 16")
        before = counts()
        _, state = venv.reset(rng.PRNGKey(43, dev))
        torch.cuda.synchronize()
        reset = tuple(a - b for a, b in zip(counts(), before))
        per_step = []
        for k in rng.split(rng.PRNGKey(143, dev), 3):
            action = rng.randint(k, (NUM_ENVS,), 0, venv.env.num_actions)
            torch.cuda.synchronize()
            before = counts()
            _, state, *_ = venv.step(state, action)
            torch.cuda.synchronize()
            per_step.append(tuple(a - b for a, b in zip(counts(), before)))
    finally:
        LevelGen._rand_objs = orig
    for env, inputs, got in calls:
        want = env._rand_objs_plain(*inputs)
        for name, g, w in zip(("d1", "d2", "redraws"), got, want):
            bad = mismatches(g, w)
            if bad:
                raise AssertionError(f"{BOSS}: a descs call of {g.shape[0]} levels, {name} "
                                     f"differs in {bad} entries")
    levels = [c[2][2].shape[0] for c in calls]
    want = (BOSS_HASHES_PER_STEP, BOSS_DESCS_PER_STEP)
    if per_step != [want] * 3:
        raise AssertionError(f"{BOSS} B={NUM_ENVS}: (threefry, descs) launches a step "
                             f"{per_step}, expected {want}")
    if 16 not in levels:
        raise AssertionError(f"{BOSS}: no 16-level refill reached the kernel: {levels}")
    log(f"  {BOSS} B={NUM_ENVS}: {len(calls)} descs calls bitwise the plain loop (levels a "
        f"call: {levels}); {reset[0]} threefry and {reset[1]} descs launches at reset, "
        f"{per_step} a step")
    return {"reset": reset, "per_step": per_step, "levels": levels}


def check_gather_doorkey(dev, obs_gather) -> tuple[int, dict]:
    """Kernel vs plain on B=4096 and ragged B=4097 DoorKey states; the whole
    observation on the card vs the same states on the CPU.  Returns (max
    error, the B=4096 inputs)."""
    from minigrid_tpu_torch.core.obs import gen_obs_batch
    from minigrid_tpu_torch.core.state import map_fields

    worst = 0
    for n in (RAGGED_ENVS, NUM_ENVS):
        env, params, st = doorkey_walk_states(dev, n, seed=20260820 + n)
        args = (st.grid, st.agent_pos, st.agent_dir, VIEW)
        got = obs_gather.gather_view(*args)
        want = obs_gather.gather_view_plain(*args)
        torch.cuda.synchronize()
        bad = mismatches(got, want)
        if bad:
            raise AssertionError(f"obs_gather kernel != plain on DoorKey states B={n}: "
                                 f"{bad} cells")
        check_flipped_bit(got, want, f"the B={n} window")
        worst = max(worst, max_abs_err(got, want))
        carrying = int((st.carrying[:, 0] != 1).sum())
        dirs = torch.bincount(st.agent_dir.long(), minlength=4).tolist()
        log(f"  DoorKey-8x8 B={n}: bitwise equal; dirs {dirs}, "
            f"{carrying} envs carrying; flipped-bit self-check caught")
    obs_gpu = gen_obs_batch(st, params)
    obs_cpu = gen_obs_batch(map_fields(lambda x: x.cpu(), st), params)
    for k in obs_cpu:
        if mismatches(obs_gpu[k].cpu(), obs_cpu[k]):
            raise AssertionError(f"observation {k!r} on the card != on the CPU")
    log("  full observation (gather, occlusion, overlay, encode): card == CPU")
    return worst, {"grid": st.grid, "pos": st.agent_pos, "dir": st.agent_dir}


FUSED_OUTPUTS = ("grid", "agent", "image", "reward", "terminated", "truncated",
                 "key", "t")


def fused_case(dev, env_id: str, walk: int, seed: int, max_steps: int | None = None,
               aim_at_goal: bool = False, num_envs: int = NUM_ENVS, **overrides):
    """Fused-step inputs on ``dev`` at B=``num_envs``: ``env_id`` levels
    after a random walk, actions over all eight, a key and a step index.
    ``max_steps`` overrides the spec's limit and spreads the step counts
    over [0, 3 * max_steps), so most lanes finish; ``aim_at_goal`` puts half
    the agents west of the goal facing it."""
    import dataclasses

    from minigrid_tpu_torch.core import rng
    from minigrid_tpu_torch.ops.fused_step import A_CNT, A_DIR, A_X, A_Y, fused_spec, \
        planes_from_states

    env, params, st = doorkey_walk_states(dev, num_envs, walk, env_id, seed, **overrides)
    planes = planes_from_states(st)
    spec = fused_spec(env, params)
    agent = planes["agent"].clone()
    k_act, k_cnt, k_step = rng.split(rng.PRNGKey(seed + 1, dev), 3).unbind(0)
    if max_steps is not None:
        spec = dataclasses.replace(spec, max_steps=max_steps)
        agent[:, A_CNT] = rng.randint(k_cnt, (num_envs,), 0, 3 * max_steps)
    if aim_at_goal:
        half = num_envs // 2
        agent[:half, A_X] = spec.width - 3
        agent[:half, A_Y] = spec.height - 2
        agent[:half, A_DIR] = 0
    action = rng.randint(k_act, (num_envs,), 0, 8)
    t = torch.zeros((), dtype=torch.int32, device=dev) + seed % 1000
    return (planes["grid"], agent, action, rng.fold_in(k_step, 0), t), spec


def compare_fused(got, want, where: str) -> int:
    """Every output bitwise; returns the largest |kernel - plain| (0 when
    equal), the reward compared as bits."""
    worst = 0
    for name, g, w in zip(FUSED_OUTPUTS, got, want):
        if w.dtype == torch.float32:
            bad = mismatches(g.view(torch.int32), w.view(torch.int32))
            err = float((g - w).abs().max()) if g.numel() else 0.0
        else:
            bad = mismatches(g, w)
            err = max_abs_err(g, w)
        if bad:
            raise AssertionError(f"fused_step kernel != plain on {where}: {name} "
                                 f"differs in {bad} entries")
        worst = max(worst, err)
    return worst


def check_fused_kernel(dev, fused_step) -> tuple[float, list]:
    """The fused step kernel against its plain version on six batches;
    returns (max error, [(case, inputs, spec)] of the DoorKey-8x8 batches
    at B=4096, for timing)."""
    cases = [
        ("DoorKey-8x8 after a 24-step walk", dict(env_id=ENV_ID, walk=24, seed=1)),
        ("DoorKey-8x8, max_steps 12", dict(env_id=ENV_ID, walk=24, seed=2, max_steps=12)),
        ("DoorKey-8x8 ragged, max_steps 12",
         dict(env_id=ENV_ID, walk=24, seed=6, max_steps=12, num_envs=RAGGED_ENVS)),
        ("Empty-5x5, half facing the goal",
         dict(env_id="MiniGrid-Empty-5x5-v0", walk=6, seed=3, max_steps=20,
              aim_at_goal=True)),
        ("Empty-Random-6x6, max_steps 10",
         dict(env_id="MiniGrid-Empty-Random-6x6-v0", walk=8, seed=4, max_steps=10)),
        ("Empty-16x16", dict(env_id="MiniGrid-Empty-16x16-v0", walk=40, seed=5)),
    ]
    worst, timed = 0.0, []
    for k, (where, kw) in enumerate(cases):
        args, spec = fused_case(dev, **kw)
        n = args[0].shape[0]
        if kw["env_id"] == ENV_ID and n == NUM_ENVS:
            timed.append((where, args, spec))
        got = fused_step.fused_step(*args, spec)
        want = fused_step.fused_step_plain(*args, spec)
        torch.cuda.synchronize()
        worst = max(worst, compare_fused(got, want, where))
        done = int((want[4] | want[5]).sum())
        goals = int((want[3] != 0).sum())
        carrying = int((args[1][:, 4] != 1).sum())
        actions = torch.bincount(args[2].long(), minlength=8).tolist()
        log(f"  fused_step {where}, B={n} {spec.width}x{spec.height} "
            f"V={spec.view}: bitwise equal; {done} lanes regenerated, {goals} "
            f"reached the goal, {carrying} carrying, actions {actions}")
        if k == 0 and (min(actions) == 0 or carrying == 0):
            raise AssertionError("the DoorKey batch misses an action or a carrier")
        if "max_steps 12" in where and done < n // 2:
            raise AssertionError(f"only {done} lanes regenerated")
        if where.startswith("Empty-5x5") and goals == 0:
            raise AssertionError("no lane reached the goal")
        if k == 0 or n == RAGGED_ENVS:
            for i, name in ((2, "image"), (0, "grid")):
                check_flipped_bit(got[i], want[i], f"the fused {name} of {where}")
            log(f"  fused_step flipped-bit self-check caught on the image and the grid "
                f"of {where}")
    return worst, timed


# -- phase 4: the main path -----------------------------------------------------

def drive_main_path(dev, counters: dict) -> dict:
    """The bench program at full width, counts zeroed just before and read
    just after; checks what comes out."""
    import minigrid_tpu_torch
    from minigrid_tpu_torch.core import rng
    from minigrid_tpu_torch.tools import bench

    venv = minigrid_tpu_torch.make_vec(ENV_ID, NUM_ENVS, reset_strategy="pooled",
                                       pool_refill=POOL_REFILL, device=dev)
    last = {}

    def keep(obs, reward, term, trunc):
        last.update(obs=obs, reward=reward, term=term, trunc=trunc)

    zero_counts(counters)
    t0 = time.perf_counter()
    acc, state = bench.run(venv, rng.PRNGKey(0, dev), MAIN_STEPS, REFILL_PERIOD,
                           on_step=keep)
    acc = float(acc)
    seconds = time.perf_counter() - t0
    launches = read_counts(counters)

    image = last["obs"]["image"]
    if image.shape != (NUM_ENVS, VIEW, VIEW, 3) or image.dtype != torch.uint8:
        raise AssertionError(f"obs image {tuple(image.shape)} {image.dtype}")
    if not torch.isfinite(torch.tensor(acc)):
        raise AssertionError(f"checksum not finite: {acc}")
    if not bool(((image[..., 0] <= 33)).all()) or not bool(
            ((last["obs"]["direction"] >= 0) & (last["obs"]["direction"] < 4)).all()):
        raise AssertionError("observation fields out of range")
    if not bool(torch.isfinite(last["reward"]).all()):
        raise AssertionError("non-finite reward")
    n_fresh, n_stale = int(state.n_fresh), int(state.n_stale)
    served = n_fresh + n_stale
    if served < NUM_ENVS:  # every env truncates at step 640
        raise AssertionError(f"only {served} auto-resets served in {MAIN_STEPS} steps")
    expected = MAIN_STEPS + 1  # one observation per step, one at reset
    if launches["obs_gather"] != expected:
        raise AssertionError(f"obs_gather launched {launches['obs_gather']} times, "
                             f"expected {expected}")
    log(f"  {ENV_ID} B={NUM_ENVS} pooled {POOL_REFILL}/{REFILL_PERIOD}: "
        f"{MAIN_STEPS} steps in {seconds:.3f} s (first run, unwarmed), "
        f"launches {launches}, auto-resets fresh {n_fresh} stale {n_stale} "
        f"(fresh fraction {n_fresh / served}), checksum {acc}")
    return {"launches": launches, "fresh_frac": n_fresh / served,
            "n_fresh": n_fresh, "n_stale": n_stale}


def same_fields(a: dict, b: dict, what: str, where: str = "") -> None:
    """Two states as numpy field dicts (nested dicts included) agree."""
    if set(a) != set(b):
        raise AssertionError(f"{what}{where}: fields differ")
    for k in a:
        if isinstance(a[k], dict):
            same_fields(a[k], b[k], what, f"{where}{k}.")
        elif (a[k] is None) != (b[k] is None) or (
                a[k] is not None and not (a[k] == b[k]).all()):
            raise AssertionError(f"{what}{where}{k} differs card vs CPU")


def card_matches_cpu(dev) -> None:
    """The same pooled program at B=16 on the card and on the CPU: per-step
    obs, reward, terminated, truncated and the final PooledState agree
    bitwise.  max_steps=3 with 4-slot windows refilled every 4 steps, so envs
    finish, consume fresh levels and replay stale ones."""
    import minigrid_tpu_torch
    from minigrid_tpu_torch.core import rng
    from minigrid_tpu_torch.tools import bench
    from minigrid_tpu_torch.utils.convert import state_to_numpy

    runs = {}
    for d in (dev, torch.device("cpu")):
        venv = minigrid_tpu_torch.make_vec(ENV_ID, 16, reset_strategy="pooled",
                                           pool_refill=4, device=d, max_steps=3)
        steps = []
        _, state = bench.run(
            venv, rng.PRNGKey(7, d), 32, 4,
            on_step=lambda obs, r, te, tr: steps.append(
                [obs["image"].cpu(), obs["direction"].cpu(), obs["mission"].cpu(),
                 r.cpu(), te.cpu(), tr.cpu()]))
        runs[d.type] = (steps, state_to_numpy(state))
    (g_steps, g_state), (c_steps, c_state) = runs["cuda"], runs["cpu"]
    for t, (g, c) in enumerate(zip(g_steps, c_steps)):
        for name, a, b in zip(("image", "direction", "mission", "reward",
                               "terminated", "truncated"), g, c):
            if mismatches(a, b):
                raise AssertionError(f"B=16 step {t}: {name} differs card vs CPU")

    same_fields(g_state, c_state, "B=16 final state ")
    log(f"  B=16, 32 steps: card == CPU bitwise (n_fresh {int(g_state['n_fresh'])}, "
        f"n_stale {int(g_state['n_stale'])})")
    # a random walk seldom reaches the goal: hold the reward formula itself
    from minigrid_tpu_torch.core.step import goal_reward

    limits = torch.tensor([12.0, 100.0, 250.0, 360.0, 640.0, 2560.0])
    count = torch.arange(1, 2561, dtype=torch.int32).repeat(len(limits))
    limit = limits.repeat_interleave(2560)
    if mismatches(goal_reward(count.to(dev), limit.to(dev)).cpu(),
                  goal_reward(count, limit)):
        raise AssertionError("goal reward differs card vs CPU")
    log(f"  goal reward: card == CPU bitwise over {count.numel()} (step, limit) pairs")


def drive_fused_path(dev, counters: dict) -> dict:
    """``FusedVectorEnv`` at full width for MAIN_STEPS steps through the
    bench's fused loop, counts zeroed just before and read just after;
    checks what comes out."""
    import minigrid_tpu_torch
    from minigrid_tpu_torch.core import rng
    from minigrid_tpu_torch.ops.fused_step import FusedVectorEnv
    from minigrid_tpu_torch.tools import bench

    env = minigrid_tpu_torch.make(ENV_ID)
    fv = FusedVectorEnv(env, NUM_ENVS, device=dev)
    actions = bench.draw_actions(rng.PRNGKey(3, dev), MAIN_STEPS, NUM_ENVS,
                                 env.num_actions)
    ended = torch.zeros((NUM_ENVS,), dtype=torch.bool, device=dev)
    last = {}

    def keep(obs, reward, term, trunc):
        ended.logical_or_(term | trunc)
        last.update(obs=obs, reward=reward)

    zero_counts(counters)
    t0 = time.perf_counter()
    acc, fs = bench.run_fused(fv, rng.PRNGKey(4, dev), actions, on_step=keep)
    acc = float(acc)
    seconds = time.perf_counter() - t0
    launches = read_counts(counters)

    if launches["fused_step"] != MAIN_STEPS or launches["obs_gather"] != 1:
        raise AssertionError(f"fused path launches {launches}: expected "
                             f"{MAIN_STEPS} fused_step and 1 obs_gather (reset)")
    image, direction = last["obs"]["image"], last["obs"]["direction"]
    if image.shape != (NUM_ENVS, VIEW, VIEW, 3) or image.dtype != torch.uint8:
        raise AssertionError(f"fused obs image {tuple(image.shape)} {image.dtype}")
    if not (bool((image[..., 0] <= 33).all()) and bool((image[..., 1] <= 10).all())
            and bool((image[..., 2] <= 2).all())):
        raise AssertionError("fused image fields out of range")
    if not bool(((direction >= 0) & (direction < 4)).all()):
        raise AssertionError("fused direction out of range")
    reward = last["reward"]
    if not (bool(torch.isfinite(reward).all()) and bool((reward >= 0).all())
            and bool((reward <= 1).all())):
        raise AssertionError("fused reward out of [0, 1]")
    ag = fs["agent"]
    w, h = fv.spec.width, fv.spec.height
    if not (bool(((ag[:, 0] > 0) & (ag[:, 0] < w - 1) & (ag[:, 1] > 0)
                  & (ag[:, 1] < h - 1)).all())
            and bool((ag[:, 3] < env.max_steps).all())):
        raise AssertionError("fused agent plane out of range")
    if not bool(ended.all()):  # every env truncates by step 640
        raise AssertionError(f"{int((~ended).sum())} envs never regenerated")
    if int(fs["t"]) != MAIN_STEPS or not torch.isfinite(torch.tensor(acc)):
        raise AssertionError(f"fused t {int(fs['t'])}, checksum {acc}")
    log(f"  {ENV_ID} B={NUM_ENVS} FusedVectorEnv: {MAIN_STEPS} steps in "
        f"{seconds:.3f} s (first run, unwarmed), launches {launches}, every env "
        f"regenerated, checksum {acc}")
    return {"launches": launches}


def fused_card_matches_cpu(dev) -> None:
    """The fused program at B=16 on the card and on the CPU (max_steps=9,
    so lanes finish and regenerate): per-step obs, reward bits, flags and
    the final planes agree bitwise."""
    import minigrid_tpu_torch
    from minigrid_tpu_torch.core import rng
    from minigrid_tpu_torch.ops.fused_step import FusedVectorEnv
    from minigrid_tpu_torch.tools import bench

    env = minigrid_tpu_torch.make(ENV_ID, max_steps=9)
    actions = bench.draw_actions(rng.PRNGKey(8, "cpu"), 40, 16, env.num_actions)
    runs = {}
    for d in (dev, torch.device("cpu")):
        steps = []
        _, fs = bench.run_fused(
            FusedVectorEnv(env, 16, device=d), rng.PRNGKey(7, d), actions.to(d),
            on_step=lambda obs, r, te, tr: steps.append(
                [obs["image"].cpu(), obs["direction"].cpu(), obs["mission"].cpu(),
                 r.cpu().view(torch.int32), te.cpu(), tr.cpu()]))
        runs[d.type] = (steps, {k: v.cpu() for k, v in fs.items()})
    (g_steps, g_fs), (c_steps, c_fs) = runs["cuda"], runs["cpu"]
    ends = 0
    for t, (g, c) in enumerate(zip(g_steps, c_steps)):
        for name, a, b in zip(("image", "direction", "mission", "reward bits",
                               "terminated", "truncated"), g, c):
            if mismatches(a, b):
                raise AssertionError(f"fused B=16 step {t}: {name} differs card vs CPU")
        ends += int((c[4] | c[5]).sum())
    for k in c_fs:
        if mismatches(g_fs[k], c_fs[k]):
            raise AssertionError(f"fused B=16 final {k} differs card vs CPU")
    log(f"  fused B=16, 40 steps: card == CPU bitwise ({ends} episode ends)")


# -- the zoo ----------------------------------------------------------------------

def zoo_walk(dev, counters: dict, env_id: str, seed: int, steps: int = ZOO_STEPS,
             **overrides) -> dict:
    """``make_vec(env_id, 4096)`` at its default strategy, ``steps`` steps of
    actions drawn before the launch counts are zeroed; checks the counts and
    the ranges of what comes out."""
    import minigrid_tpu_torch
    from minigrid_tpu_torch.core import rng
    from minigrid_tpu_torch.tools import bench

    venv = minigrid_tpu_torch.make_vec(env_id, NUM_ENVS, device=dev, **overrides)
    env = venv.env
    actions = bench.draw_actions(rng.PRNGKey(seed, dev), steps, NUM_ENVS,
                                 env.num_actions)
    grammar = getattr(env, "grammar_missions", False)
    codes = torch.from_numpy(env.mission_codes()).to(dev)
    ends = torch.zeros((), dtype=torch.int64, device=dev)
    r_lo = torch.full((), float("inf"), device=dev)
    r_hi = torch.full((), -float("inf"), device=dev)
    zero_counts(counters)
    t0 = time.perf_counter()
    obs, state = venv.reset(rng.PRNGKey(seed + 1, dev))
    for a in actions:
        obs, state, reward, term, trunc, _ = venv.step(state, a)
        ends += (term | trunc).sum()
        r_lo = torch.minimum(r_lo, reward.min())
        r_hi = torch.maximum(r_hi, reward.max())
    ends, r_lo, r_hi = int(ends), float(r_lo), float(r_hi)
    seconds = time.perf_counter() - t0
    launches = read_counts(counters)
    if launches != {"obs_gather": steps + 1, "fused_step": 0}:
        raise AssertionError(f"{env_id}: launches {launches}, expected "
                             f"{steps + 1} obs_gather (one per observation)")
    v = venv.params.agent_view_size
    image, direction, mission = obs["image"], obs["direction"], obs["mission"]
    if image.shape != (NUM_ENVS, v, v, 3) or image.dtype != torch.uint8:
        raise AssertionError(f"{env_id}: image {tuple(image.shape)} {image.dtype}")
    if not (bool((image[..., 0] <= 33).all()) and bool((image[..., 1] <= 10).all())
            and bool((image[..., 2] <= 2).all())):
        raise AssertionError(f"{env_id}: image fields out of range")
    if not bool(((direction >= 0) & (direction < 4)).all()):
        raise AssertionError(f"{env_id}: direction out of range")
    if grammar and mission.shape[1] == 43:
        # BabyAI: the 43-int instruction code, its sequencing and clause kinds
        # in range and the first clause set
        kinds = mission[:, 3:7]
        if (mission.shape != (NUM_ENVS, 43) or not bool((mission[:, 0] <= 3).all())
                or not bool(((kinds >= 0) & (kinds <= 4)).all())
                or not bool((kinds[:, 0] > 0).all())):
            raise AssertionError(f"{env_id}: missions out of range")
    elif grammar:
        # a template grammar (Negated, Directions): a code per env
        if mission.shape[0] != NUM_ENVS or mission.dtype != torch.int32:
            raise AssertionError(f"{env_id}: missions {tuple(mission.shape)}")
    elif not bool((mission[:, None, :] == codes[None]).all(-1).any(-1).all()):
        raise AssertionError(f"{env_id}: a mission outside the env's codes")
    floor = -1.0 if any(f in env_id for f in NEGATIVE_REWARDS) else 0.0
    if not (floor <= r_lo and r_hi <= 1.0):
        raise AssertionError(f"{env_id}: reward outside [{floor}, 1]: {r_lo}..{r_hi}")
    envs = state.envs if hasattr(state, "envs") else state
    out = {"venv": venv, "envs": envs, "ends": ends, "seconds": seconds,
           "reward": (r_lo, r_hi), "launches": launches}
    if hasattr(state, "n_fresh"):
        n_fresh, n_stale = int(state.n_fresh), int(state.n_stale)
        out["fresh"] = (n_fresh, n_stale)
    return out


def check_zoo_gather(obs_gather, envs, view: int, what: str, flip: bool) -> int:
    """The gather kernel against its plain version on a batch of states."""
    args = (envs.grid, envs.agent_pos, envs.agent_dir, view)
    got = obs_gather.gather_view(*args)
    want = obs_gather.gather_view_plain(*args)
    torch.cuda.synchronize()
    bad = mismatches(got, want)
    if bad:
        raise AssertionError(f"obs_gather kernel != plain on {what}: {bad} cells")
    if flip:
        check_flipped_bit(got, want, f"the window of {what}")
    return max_abs_err(got, want)


def zoo_card_matches_cpu(dev, env_id: str, seed: int, steps: int = 32,
                         num_envs: int = 16, max_steps: int | None = 8,
                         final=None) -> int:
    """B=``num_envs`` for ``steps`` steps with ``max_steps`` (None: the
    preset) on the card and on the CPU: per-step observation, reward bits
    and flags, and the final state (``extra`` and a pooled ring included)
    agree bitwise.  ``final(state)`` checks the CPU's final state.  Returns
    the episode ends."""
    import minigrid_tpu_torch
    from minigrid_tpu_torch.core import rng
    from minigrid_tpu_torch.tools import bench
    from minigrid_tpu_torch.utils.convert import state_to_numpy

    actions = bench.draw_actions(rng.PRNGKey(seed, "cpu"), steps, num_envs, 8)
    runs = []
    limit = {} if max_steps is None else {"max_steps": max_steps}
    for d in (dev, torch.device("cpu")):
        venv = minigrid_tpu_torch.make_vec(env_id, num_envs, device=d, **limit)
        _, state = venv.reset(rng.PRNGKey(seed, d))
        steps = []
        for a in actions:
            obs, state, r, te, tr, _ = venv.step(state, a.to(d))
            steps.append([obs["image"].cpu(), obs["direction"].cpu(),
                          obs["mission"].cpu(), r.cpu().view(torch.int32), te.cpu(),
                          tr.cpu()])
        runs.append((steps, state_to_numpy(state)))
    if final is not None:
        final(state)
    (g_steps, g_state), (c_steps, c_state) = runs
    ends = 0
    for t, (g, c) in enumerate(zip(g_steps, c_steps)):
        for name, a, b in zip(("image", "direction", "mission", "reward bits",
                               "terminated", "truncated"), g, c):
            if mismatches(a, b):
                raise AssertionError(f"{env_id} B={num_envs} step {t}: {name} differs "
                                     f"card vs CPU")
        ends += int((c[4] | c[5]).sum())
    same_fields(g_state, c_state, f"{env_id} B={num_envs} final state ")
    return ends


def drive_zoo(dev, counters: dict, obs_gather, card: str) -> dict:
    """Every family of ZOO on the card; returns what the kernel table and
    PERF.md read."""
    import minigrid_tpu_torch
    from minigrid_tpu_torch.core import rng
    from minigrid_tpu_torch.tools import bench

    worst, out = 0, {"rates": {}}
    for i, (env_id, strategy, refill) in enumerate(ZOO):
        t_family = time.perf_counter()
        walk = zoo_walk(dev, counters, env_id, seed=100 + i)
        venv = walk["venv"]
        if (venv.reset_strategy, venv.pool_refill) != (strategy, refill):
            raise AssertionError(f"{env_id}: strategy {venv.reset_strategy}/"
                                 f"{venv.pool_refill}, the JAX package picks "
                                 f"{strategy}/{refill}")
        short = zoo_walk(dev, counters, env_id, seed=200 + i,
                         max_steps=ZOO_SHORT_EPISODE)
        if short["ends"] < ZOO_STEPS // ZOO_SHORT_EPISODE * NUM_ENVS:
            raise AssertionError(f"{env_id}: only {short['ends']} episode ends in "
                                 f"{ZOO_STEPS} steps at max_steps {ZOO_SHORT_EPISODE}")
        v = venv.params.agent_view_size
        w, h = venv.params.width, venv.params.height
        is_multiroom = env_id == MULTIROOM
        worst = max(worst, check_zoo_gather(obs_gather, short["envs"], v,
                                            f"{env_id} B={NUM_ENVS}", is_multiroom))
        ends16 = zoo_card_matches_cpu(dev, env_id, seed=300 + i)
        rate = bench.measure_steps(venv, ZOO_TIMED_STEPS)
        out["rates"][env_id] = rate
        log(f"  {env_id} {w}x{h}{' see-through' if venv.params.see_through_walls else ''}"
            f": {venv.reset_strategy}, pool_refill {venv.pool_refill} (as the JAX "
            f"package picks); {ZOO_STEPS} steps at max_steps {venv.env.max_steps}: "
            f"{walk['ends']} episode ends, {walk['seconds']:.2f} s; at max_steps "
            f"{ZOO_SHORT_EPISODE}: {short['ends']} ends, {short['seconds']:.2f} s; "
            f"launches {short['launches']} each walk; rewards in [{walk['reward'][0]}, "
            f"{max(walk['reward'][1], short['reward'][1])}]; gather bitwise; "
            f"B=16 card == CPU ({ends16} ends); "
            f"{rate['env_steps_per_sec']:.0f} env-steps/s, {rate['us_per_step']:.1f} "
            f"us/step ({rate['strategy']}, predrawn, {ZOO_TIMED_STEPS} steps"
            f"{', fresh fraction ' + str(rate.get('fresh_frac')) if 'fresh_frac' in rate else ''}"
            f"); {time.perf_counter() - t_family:.1f} s [{card}]")
        if is_multiroom:
            out["multiroom_inputs"] = {"grid": short["envs"].grid,
                                       "pos": short["envs"].agent_pos,
                                       "dir": short["envs"].agent_dir}

    # MultiRoom at short episodes, pooled against conditional (a host read
    # of `done` every step, then generation for just the finished envs)
    for strategy in ("pooled", "conditional"):
        rate = bench.measure_steps(minigrid_tpu_torch.make_vec(
            MULTIROOM, NUM_ENVS, device=dev, reset_strategy=strategy,
            max_steps=ZOO_SHORT_EPISODE), ZOO_TIMED_STEPS)
        out["rates"][f"{MULTIROOM} {strategy}, max_steps {ZOO_SHORT_EPISODE}"] = rate
        log(f"  {MULTIROOM} B={NUM_ENVS} {strategy}, max_steps {ZOO_SHORT_EPISODE}: "
            f"{rate['env_steps_per_sec']:.0f} env-steps/s, {rate['us_per_step']:.1f} "
            f"us/step (predrawn, {ZOO_TIMED_STEPS} steps"
            f"{', fresh fraction ' + str(rate.get('fresh_frac')) if 'fresh_frac' in rate else ''}"
            f") [{card}]")

    # a ragged 25x25 batch: one env in the last tile
    env = minigrid_tpu_torch.make(MULTIROOM)
    k_gen, k_act = rng.split(rng.PRNGKey(7, dev)).unbind(0)
    st = env.generate(rng.split(k_gen, RAGGED_ENVS), env.default_params, dev)
    for k in rng.split(k_act, 8):
        st = env.step_state(st, rng.randint(k, (RAGGED_ENVS,), 0, 8),
                            env.default_params)[0]
    worst = max(worst, check_zoo_gather(obs_gather, st, VIEW,
                                        f"{MULTIROOM} B={RAGGED_ENVS}", True))
    log(f"  {MULTIROOM} 25x25 gather: bitwise at B={NUM_ENVS} and B={RAGGED_ENVS}, "
        f"flipped-bit self-checks caught")

    # rollout with bulk refills, pooled; short episodes, so the ring serves
    env = minigrid_tpu_torch.make(MULTIROOM, max_steps=ZOO_SHORT_EPISODE)
    zero_counts(counters)
    t0 = time.perf_counter()
    st, traj = minigrid_tpu_torch.rollout(env, None, rng.PRNGKey(9, dev), NUM_ENVS,
                                          ZOO_ROLLOUT_STEPS, refill_period=8,
                                          device=dev)
    n_fresh, n_stale = int(st.n_fresh), int(st.n_stale)
    seconds = time.perf_counter() - t0
    ends = int((traj["terminated"] | traj["truncated"]).sum())
    gathers = read_counts(counters)["obs_gather"]
    if (traj["action"].shape != (ZOO_ROLLOUT_STEPS, NUM_ENVS)
            or gathers != ZOO_ROLLOUT_STEPS + 1
            or not bool(torch.isfinite(traj["reward"]).all())
            or n_fresh + n_stale != ends or n_fresh == 0):
        raise AssertionError(f"rollout: {tuple(traj['action'].shape)}, "
                             f"{gathers} gathers, {ends} ends, "
                             f"fresh {n_fresh} stale {n_stale}")
    log(f"  rollout({MULTIROOM}, max_steps {ZOO_SHORT_EPISODE}, B={NUM_ENVS}, "
        f"{ZOO_ROLLOUT_STEPS} steps, refill_period=8, pooled at the family's window): "
        f"{seconds:.2f} s, {ZOO_ROLLOUT_STEPS + 1} gathers, auto-resets fresh "
        f"{n_fresh} stale {n_stale} [{card}]")

    # launches per step of a cheap family and of MultiRoom
    out["profiles"] = {}
    for env_id in ("MiniGrid-LavaGapS7-v0", MULTIROOM):
        prof = bench.profile_steps(minigrid_tpu_torch.make_vec(env_id, NUM_ENVS,
                                                               device=dev), 8)
        out["profiles"][env_id] = prof
        log(f"  {env_id} B={NUM_ENVS} {prof['strategy']} under torch.profiler, 8 "
            f"steps: {prof['launches_per_step']:.1f} launches/step, device busy "
            f"{prof['device_busy_us_per_step']:.1f} us/step of "
            f"{prof['wall_us_per_step']:.1f} wall, idle share "
            f"{prof['device_idle_share']:.3f} [{card}]")
    out["max_abs_err"] = worst
    return out


# -- the multi-room families ----------------------------------------------------

def drive_roomgrid(dev, counters: dict, obs_gather, card: str) -> dict:
    """Every family of ROOMGRID on the card: a walk at the preset max_steps
    and one at ZOO_SHORT_EPISODE (its fresh fraction when pooled), the
    gather bitwise on its states, card == CPU at B=16, env-steps/s; the
    gather on KeyCorridorS3R1's 7x3 grid at the ragged B=4097; launches per
    step of ROOMGRID_PROFILED.  Returns what the kernel table and PERF.md
    read."""
    import minigrid_tpu_torch
    from minigrid_tpu_torch.core import rng
    from minigrid_tpu_torch.tools import bench

    worst, out = 0, {"rates": {}, "inputs": {}}
    for i, (env_id, strategy, refill) in enumerate(ROOMGRID):
        t_family = time.perf_counter()
        walk = zoo_walk(dev, counters, env_id, seed=400 + i, steps=ROOMGRID_STEPS)
        venv = walk["venv"]
        if (venv.reset_strategy, venv.pool_refill) != (strategy, refill):
            raise AssertionError(f"{env_id}: strategy {venv.reset_strategy}/"
                                 f"{venv.pool_refill}, the JAX package picks "
                                 f"{strategy}/{refill}")
        short = zoo_walk(dev, counters, env_id, seed=500 + i,
                         steps=ROOMGRID_SHORT_STEPS, max_steps=ZOO_SHORT_EPISODE)
        waves = ROOMGRID_SHORT_STEPS // ZOO_SHORT_EPISODE
        if short["ends"] < waves * NUM_ENVS:
            raise AssertionError(f"{env_id}: only {short['ends']} episode ends in "
                                 f"{ROOMGRID_SHORT_STEPS} steps at max_steps "
                                 f"{ZOO_SHORT_EPISODE}")
        fresh = ""
        if "fresh" in short:
            n_fresh, n_stale = short["fresh"]
            if n_fresh + n_stale != short["ends"] or n_fresh == 0:
                raise AssertionError(f"{env_id}: ring served fresh {n_fresh} stale "
                                     f"{n_stale} for {short['ends']} ends")
            fresh = (f", ring fresh {n_fresh} stale {n_stale} (fresh fraction "
                     f"{n_fresh / (n_fresh + n_stale)})")
            out.setdefault("fresh", {})[env_id] = (n_fresh, n_stale)
        v = venv.params.agent_view_size
        w, h = venv.params.width, venv.params.height
        envs = short["envs"]
        worst = max(worst, check_zoo_gather(obs_gather, envs, v,
                                            f"{env_id} B={NUM_ENVS}", True))
        out["inputs"][env_id] = {"grid": envs.grid, "pos": envs.agent_pos,
                                 "dir": envs.agent_dir}
        ends16 = zoo_card_matches_cpu(dev, env_id, seed=600 + i,
                                      steps=ROOMGRID_CPU_STEPS)
        rate = bench.measure_steps(venv, ZOO_TIMED_STEPS)
        out["rates"][env_id] = rate
        log(f"  {env_id} {w}x{h}: {venv.reset_strategy}, pool_refill "
            f"{venv.pool_refill} (as the JAX package picks); {ROOMGRID_STEPS} steps "
            f"at max_steps {venv.env.max_steps}: {walk['ends']} episode ends, "
            f"{walk['seconds']:.2f} s; {ROOMGRID_SHORT_STEPS} at max_steps "
            f"{ZOO_SHORT_EPISODE}: {short['ends']} ends, {short['seconds']:.2f} s"
            f"{fresh}; launches {short['launches']} in the short walk; rewards in "
            f"[{walk['reward'][0]}, {max(walk['reward'][1], short['reward'][1])}]; "
            f"gather bitwise, flipped-bit self-check caught; B=16 card == CPU "
            f"({ROOMGRID_CPU_STEPS} steps, {ends16} ends); "
            f"{rate['env_steps_per_sec']:.0f} env-steps/s, {rate['us_per_step']:.1f} "
            f"us/step ({rate['strategy']}, predrawn, best of 2 x {ZOO_TIMED_STEPS} "
            f"steps); {time.perf_counter() - t_family:.1f} s [{card}]")

    # the 7x3 grid, narrower than the view, at a ragged batch
    env = minigrid_tpu_torch.make(NARROW)
    k_gen, k_act = rng.split(rng.PRNGKey(11, dev)).unbind(0)
    st = env.generate(rng.split(k_gen, RAGGED_ENVS), env.default_params, dev)
    for k in rng.split(k_act, 8):
        st = env.step_state(st, rng.randint(k, (RAGGED_ENVS,), 0, 8),
                            env.default_params)[0]
    worst = max(worst, check_zoo_gather(obs_gather, st, VIEW,
                                        f"{NARROW} B={RAGGED_ENVS}", True))
    log(f"  {NARROW} {env.width}x{env.height} gather: bitwise at B={RAGGED_ENVS}, "
        f"flipped-bit self-check caught")

    out["profiles"] = {}
    for env_id in ROOMGRID_PROFILED:
        prof = bench.profile_steps(minigrid_tpu_torch.make_vec(env_id, NUM_ENVS,
                                                               device=dev),
                                   ROOMGRID_PROFILE_STEPS)
        out["profiles"][env_id] = prof
        log(f"  {env_id} B={NUM_ENVS} {prof['strategy']} under torch.profiler, "
            f"{ROOMGRID_PROFILE_STEPS} steps: {prof['launches_per_step']:.1f} "
            f"launches/step, device busy "
            f"{prof['device_busy_us_per_step']:.1f} us/step of "
            f"{prof['wall_us_per_step']:.1f} wall, idle share "
            f"{prof['device_idle_share']:.3f} [{card}]")
    out["max_abs_err"] = worst
    return out


# -- BabyAI ------------------------------------------------------------------------

def drive_babyai(dev, counters: dict, obs_gather, card: str) -> dict:
    """Every level of BABYAI on the card: a walk of BABYAI_STEPS at
    BABYAI_EPISODE (launch counts, the ring's fresh fraction), the gather
    bitwise on its states, card == CPU at B=64 pooled, env-steps/s at the
    preset limits; the gather on OpenRedDoor's 9x5 grid; launches per step
    of BABYAI_PROFILED.  Returns what the kernel table and PERF.md read."""
    import minigrid_tpu_torch
    from minigrid_tpu_torch.core import rng
    from minigrid_tpu_torch.tools import bench

    worst, out = 0, {"rates": {}, "inputs": {}, "fresh": {}}

    def dynamic_limit(state):
        if not bool((state.envs.max_steps == 16).all()):
            raise AssertionError("GoToObjS4: per-episode max_steps is not 16")

    for i, (env_id, strategy, refill) in enumerate(BABYAI):
        t_level = time.perf_counter()
        walk = zoo_walk(dev, counters, env_id, seed=700 + i, steps=BABYAI_STEPS,
                        max_steps=BABYAI_EPISODE)
        venv = walk["venv"]
        if (venv.reset_strategy, venv.pool_refill) != (strategy, refill):
            raise AssertionError(f"{env_id}: strategy {venv.reset_strategy}/"
                                 f"{venv.pool_refill}, the JAX package picks "
                                 f"{strategy}/{refill}")
        if not venv.best_effort_refill:
            raise AssertionError(f"{env_id}: the refill is not best-effort")
        waves = BABYAI_STEPS // BABYAI_EPISODE
        n_fresh, n_stale = walk["fresh"]
        if walk["ends"] < waves * NUM_ENVS or n_fresh + n_stale != walk["ends"]:
            raise AssertionError(f"{env_id}: {walk['ends']} episode ends, ring served "
                                 f"fresh {n_fresh} stale {n_stale}")
        out["fresh"][env_id] = (n_fresh, n_stale)
        envs = walk["envs"]
        w, h = venv.params.width, venv.params.height
        worst = max(worst, check_zoo_gather(obs_gather, envs, VIEW,
                                            f"{env_id} B={NUM_ENVS}", True))
        out["inputs"][f"{w}x{h}"] = {"grid": envs.grid, "pos": envs.agent_pos,
                                     "dir": envs.agent_dir}
        is_s4 = env_id == "BabyAI-GoToObjS4-v0"
        ends64 = zoo_card_matches_cpu(
            dev, env_id, seed=800 + i, steps=BABYAI_CPU_STEPS, num_envs=BABYAI_CPU_ENVS,
            max_steps=None if is_s4 else BABYAI_EPISODE,
            final=dynamic_limit if is_s4 else None)
        rate = bench.measure_steps(minigrid_tpu_torch.make_vec(env_id, NUM_ENVS,
                                                               device=dev),
                                   BABYAI_TIMED_STEPS)
        out["rates"][env_id] = rate
        log(f"  {env_id} {w}x{h}: {venv.reset_strategy}, pool_refill {venv.pool_refill}, "
            f"best-effort refill (as the JAX package picks); {BABYAI_STEPS} steps at "
            f"max_steps {BABYAI_EPISODE}: {walk['ends']} ends, {walk['seconds']:.2f} s, "
            f"ring fresh {n_fresh} stale {n_stale} (fresh fraction "
            f"{n_fresh / (n_fresh + n_stale)}); launches {walk['launches']}; rewards in "
            f"[{walk['reward'][0]}, {walk['reward'][1]}]; gather bitwise, flipped-bit "
            f"self-check caught; B={BABYAI_CPU_ENVS} pooled card == CPU "
            f"({BABYAI_CPU_STEPS} steps, {ends64} ends, verifier state included); "
            f"{rate['env_steps_per_sec']:.0f} env-steps/s, {rate['us_per_step']:.1f} "
            f"us/step ({rate['strategy']}/{rate['pool_refill']}, preset max_steps, "
            f"predrawn, best of 2 x {BABYAI_TIMED_STEPS} steps, fresh fraction "
            f"{rate.get('fresh_frac')}); {time.perf_counter() - t_level:.1f} s [{card}]")

    # OpenRedDoor's 9x5 grid: two rooms of 5 side by side
    env = minigrid_tpu_torch.make(BABYAI_9X5)
    k_gen, k_act = rng.split(rng.PRNGKey(13, dev)).unbind(0)
    st = env.generate(rng.split(k_gen, RAGGED_ENVS), env.default_params, dev)
    for k in rng.split(k_act, 8):
        st = env.step_state(st, rng.randint(k, (RAGGED_ENVS,), 0, 8),
                            env.default_params)[0]
    worst = max(worst, check_zoo_gather(obs_gather, st, VIEW,
                                        f"{BABYAI_9X5} B={RAGGED_ENVS}", True))
    out["inputs"]["9x5"] = {"grid": st.grid[:NUM_ENVS], "pos": st.agent_pos[:NUM_ENVS],
                            "dir": st.agent_dir[:NUM_ENVS]}
    log(f"  {BABYAI_9X5} {env.width}x{env.height} gather: bitwise at B={RAGGED_ENVS}, "
        f"flipped-bit self-check caught")

    out["profiles"] = {}
    for env_id in BABYAI_PROFILED:
        prof = bench.profile_steps(minigrid_tpu_torch.make_vec(env_id, NUM_ENVS,
                                                               device=dev),
                                   BABYAI_PROFILE_STEPS)
        out["profiles"][env_id] = prof
        log(f"  {env_id} B={NUM_ENVS} {prof['strategy']}/{prof['pool_refill']} under "
            f"torch.profiler, {BABYAI_PROFILE_STEPS} steps: "
            f"{prof['launches_per_step']:.1f} launches/step, device busy "
            f"{prof['device_busy_us_per_step']:.1f} us/step of "
            f"{prof['wall_us_per_step']:.1f} wall, idle share "
            f"{prof['device_idle_share']:.3f} [{card}]")
    out["max_abs_err"] = worst
    return out


# -- phase 4e: the level generator, PutNext, Unlock, other; the dataset envs -----

def drive_slice_b(dev, counters: dict, obs_gather, card: str) -> dict:
    """Every id of SLICE_B on the card: a walk of SLICE_B_STEPS (BabyAI at
    SLICE_B_EPISODE; launch counts, the ring's fresh fraction), the gather
    bitwise on its states with the flipped-bit self-check, card == CPU at
    B=64, env-steps/s at the preset limits; the gather at Directions' 3x3 /
    V=3 and OneRoomS20's 20x20 on a ragged batch; the launches per step of
    SLICE_B_PROFILED.  Returns what the kernel table and PERF.md read."""
    import minigrid_tpu_torch
    from minigrid_tpu_torch.tools import bench

    worst, out = 0, {"rates": {}, "inputs": {}, "fresh": {}, "seconds": {}}
    for i, (env_id, strategy, refill) in enumerate(SLICE_B):
        t_id = time.perf_counter()
        babyai = env_id.startswith("BabyAI-")
        # the dataset envs fix max_steps in their constructors
        limit = {"max_steps": SLICE_B_EPISODE} if babyai else {}
        walk = zoo_walk(dev, counters, env_id, seed=900 + i, steps=SLICE_B_STEPS, **limit)
        venv = walk["venv"]
        if (venv.reset_strategy, venv.pool_refill) != (strategy, refill):
            raise AssertionError(f"{env_id}: strategy {venv.reset_strategy}/"
                                 f"{venv.pool_refill}, the JAX package picks "
                                 f"{strategy}/{refill}")
        if venv.best_effort_refill != babyai:
            raise AssertionError(f"{env_id}: best-effort refill {venv.best_effort_refill}")
        ring = ""
        if babyai:
            n_fresh, n_stale = walk["fresh"]
            waves = SLICE_B_STEPS // SLICE_B_EPISODE
            if walk["ends"] < waves * NUM_ENVS or n_fresh + n_stale != walk["ends"]:
                raise AssertionError(f"{env_id}: {walk['ends']} episode ends, ring "
                                     f"served fresh {n_fresh} stale {n_stale}")
            out["fresh"][env_id] = (n_fresh, n_stale)
            ring = (f", ring fresh {n_fresh} stale {n_stale} (fresh fraction "
                    f"{n_fresh / (n_fresh + n_stale)})")
        elif env_id in (DIRECTIONS, "BlocksDataset-v0") and (
                walk["ends"] < SLICE_B_STEPS // 2 * NUM_ENVS):
            # scripted: every episode ends after one or two steps
            raise AssertionError(f"{env_id}: only {walk['ends']} episode ends")
        envs = walk["envs"]
        v = venv.params.agent_view_size
        w, h = venv.params.width, venv.params.height
        worst = max(worst, check_zoo_gather(obs_gather, envs, v,
                                            f"{env_id} {w}x{h} B={NUM_ENVS}", True))
        out["inputs"][env_id] = {"grid": envs.grid, "pos": envs.agent_pos,
                                 "dir": envs.agent_dir, "view": v}
        ends64 = zoo_card_matches_cpu(dev, env_id, seed=1000 + i, steps=SLICE_B_CPU_STEPS,
                                      num_envs=BABYAI_CPU_ENVS,
                                      max_steps=SLICE_B_EPISODE if babyai else None)
        rate = bench.measure_steps(minigrid_tpu_torch.make_vec(env_id, NUM_ENVS,
                                                               device=dev),
                                   SLICE_B_TIMED_STEPS)
        out["rates"][env_id] = rate
        out["seconds"][env_id] = time.perf_counter() - t_id
        log(f"  {env_id} {w}x{h} V={v}: {venv.reset_strategy}, pool_refill "
            f"{venv.pool_refill}{', best-effort refill' if babyai else ''} (as the JAX "
            f"package picks); {SLICE_B_STEPS} steps at max_steps {venv.env.max_steps}: "
            f"{walk['ends']} ends, {walk['seconds']:.2f} s{ring}; launches "
            f"{walk['launches']}; rewards in [{walk['reward'][0]}, {walk['reward'][1]}]; "
            f"gather bitwise, flipped-bit self-check caught; B={BABYAI_CPU_ENVS} card "
            f"== CPU ({SLICE_B_CPU_STEPS} steps, {ends64} ends); "
            f"{rate['env_steps_per_sec']:.0f} env-steps/s, {rate['us_per_step']:.1f} "
            f"us/step ({rate['strategy']}/{rate['pool_refill']}, preset max_steps, "
            f"predrawn, best of 2 x {SLICE_B_TIMED_STEPS} steps, fresh fraction "
            f"{rate.get('fresh_frac')}); {out['seconds'][env_id]:.1f} s [{card}]")

    # the smallest grid and view, and the widest one-room grid, each with
    # one env in the last tile
    t0 = time.perf_counter()
    for env_id, seed in ((DIRECTIONS, 17), (ONE_ROOM_20, 19)):
        env, params, st = doorkey_walk_states(dev, RAGGED_ENVS, steps=8, env_id=env_id,
                                              seed=seed)
        v = params.agent_view_size
        worst = max(worst, check_zoo_gather(obs_gather, st, v, f"{env_id} "
                                            f"B={RAGGED_ENVS}", True))
        log(f"  {env_id} {env.width}x{env.height} V={v} gather: bitwise at "
            f"B={RAGGED_ENVS}, flipped-bit self-check caught")
    out["seconds"]["ragged gathers"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    prof = bench.profile_steps(minigrid_tpu_torch.make_vec(SLICE_B_PROFILED, NUM_ENVS,
                                                           device=dev),
                               SLICE_B_PROFILE_STEPS)
    out["profiles"] = {SLICE_B_PROFILED: prof}
    log(f"  {SLICE_B_PROFILED} B={NUM_ENVS} {prof['strategy']}/{prof['pool_refill']} "
        f"under torch.profiler, {SLICE_B_PROFILE_STEPS} steps: "
        f"{prof['launches_per_step']:.1f} launches/step, device busy "
        f"{prof['device_busy_us_per_step']:.1f} us/step of "
        f"{prof['wall_us_per_step']:.1f} wall, idle share "
        f"{prof['device_idle_share']:.3f}; {time.perf_counter() - t0:.1f} s with the "
        f"reset and the trace's summary [{card}]")
    out["max_abs_err"] = worst
    return out


# -- phase 4f: the wrappers and the renderer ---------------------------------------

def make_wrapped(env_id: str, wrapper: str, kwargs: dict, **overrides):
    import minigrid_tpu_torch
    from minigrid_tpu_torch import wrappers

    return getattr(wrappers, wrapper)(minigrid_tpu_torch.make(env_id, **overrides),
                                      **kwargs)


def obs_leaves(obs) -> list:
    """(name, tensor) of every leaf of an observation, a tensor or a dict."""
    if isinstance(obs, dict):
        return [(f"{k}.{n}" if n else k, t) for k in sorted(obs)
                for n, t in obs_leaves(obs[k])]
    return [("", obs)]


def ulp_apart(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance in float32 ulps of two tensors (nan == nan;
    a nan against a number counts as 2^31)."""
    if a.dtype != torch.float32:
        return 0 if not mismatches(a, b) else 2 ** 31
    ai, bi = a.view(torch.int32).long(), b.view(torch.int32).long()
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    if bool((nan_a != nan_b).any()):
        return 2 ** 31
    d = torch.where(nan_a, 0, (ai - bi).abs())
    return int(d.max()) if d.numel() else 0


def wrapped_walk(dev, counters: dict, venv, seed: int, gathers: int) -> dict:
    """WRAPPED_STEPS steps of predrawn actions with the launch counts zeroed
    just before the reset; obs_gather must launch ``gathers`` times an
    observation and fused_step never."""
    from minigrid_tpu_torch.core import rng
    from minigrid_tpu_torch.tools import bench

    actions = bench.draw_actions(rng.PRNGKey(seed, dev), WRAPPED_STEPS, venv.num_envs,
                                 venv.env.num_actions)
    ends = torch.zeros((), dtype=torch.int64, device=dev)
    r_lo = torch.full((), float("inf"), device=dev)
    r_hi = torch.full((), -float("inf"), device=dev)
    zero_counts(counters)
    t0 = time.perf_counter()
    obs, state = venv.reset(rng.PRNGKey(seed + 1, dev))
    for a in actions:
        obs, state, reward, term, trunc, _ = venv.step(state, a)
        ends += (term | trunc).sum()
        r_lo = torch.minimum(r_lo, reward.min())
        r_hi = torch.maximum(r_hi, reward.max())
    ends, r_lo, r_hi = int(ends), float(r_lo), float(r_hi)
    seconds = time.perf_counter() - t0
    launches = read_counts(counters)
    want = {"obs_gather": (WRAPPED_STEPS + 1) * gathers, "fused_step": 0}
    if launches != want:
        raise AssertionError(f"{type(venv.env).__name__}: launches {launches}, "
                             f"expected {want}")
    return {"obs": obs, "state": state, "ends": ends, "reward": (r_lo, r_hi),
            "seconds": seconds, "launches": launches}


def wrapped_card_matches_cpu(dev, make, seed: int) -> tuple[int, int]:
    """``make()`` on the card and on the CPU, B=WRAPPED_CPU_ENVS for
    WRAPPED_STEPS steps (episodes of WRAPPED_CPU_EPISODE): every observation leaf, end flag and the final state
    (a bonus wrapper's counts, a pooled ring) bitwise; the rewards and float
    observation leaves within FLOAT_ULP.  Returns (episode ends, the largest
    ulp distance seen)."""
    from minigrid_tpu_torch.core import rng
    from minigrid_tpu_torch.parallel.vector import VectorEnv
    from minigrid_tpu_torch.tools import bench
    from minigrid_tpu_torch.utils.convert import state_to_numpy

    env = make()
    actions = bench.draw_actions(rng.PRNGKey(seed, "cpu"), WRAPPED_STEPS,
                                 WRAPPED_CPU_ENVS, env.num_actions)
    runs = []
    for d in (dev, torch.device("cpu")):
        venv = VectorEnv(env, WRAPPED_CPU_ENVS, device=d)
        obs, state = venv.reset(rng.PRNGKey(seed, d))
        steps = [[t.cpu() for _, t in obs_leaves(obs)]]
        for a in actions:
            obs, state, r, te, tr, _ = venv.step(state, a.to(d))
            steps.append([t.cpu() for _, t in obs_leaves(obs)]
                         + [r.cpu(), te.cpu(), tr.cpu()])
        runs.append((steps, state_to_numpy(state)))
    (g_steps, g_state), (c_steps, c_state) = runs
    name = type(env).__name__
    worst, ends = 0, 0
    for t, (g, c) in enumerate(zip(g_steps, c_steps)):
        for a, b in zip(g, c):
            if a.dtype == torch.float32:
                d = ulp_apart(a, b)
                if d > FLOAT_ULP:
                    raise AssertionError(f"{name} step {t}: {d} ulp card vs CPU")
                worst = max(worst, d)
            elif mismatches(a, b):
                raise AssertionError(f"{name} step {t}: a leaf differs card vs CPU")
        if t:
            ends += int((c[-2] | c[-1]).sum())
    same_fields(g_state, c_state, f"{name} B={WRAPPED_CPU_ENVS} final state ")
    return ends, worst


def check_renders(dev) -> None:
    """The renders on the card against the CPU on a ragged batch of walked
    DoorKey-8x8 states, each with the flipped-pixel self-check; get_frame at
    32 pixels."""
    from minigrid_tpu_torch.core.state import map_fields
    from minigrid_tpu_torch.ops import render as R

    env, params, st = doorkey_walk_states(dev, RAGGED_ENVS, steps=24, seed=33)
    cpu = map_fields(lambda x: x.cpu(), st)
    renders = {
        "pov_render_batch HWC": lambda s, a: R.pov_render_batch(s, params, a),
        "pov_render_batch CHW": lambda s, a: R.pov_render_batch(s, params, a,
                                                                channels_first=True),
        "full_render highlight": lambda s, a: R.full_render(s, params, a, True),
        "full_render plain": lambda s, a: R.full_render(s, params, a, False),
    }
    for name, fn in renders.items():
        got = fn(st, R.get_atlas(TILE, dev)).cpu()
        want = fn(cpu, R.get_atlas(TILE, "cpu"))
        if mismatches(got, want):
            raise AssertionError(f"{name} B={RAGGED_ENVS}: card != CPU")
        check_flipped_bit(got, want, f"the frames of {name}")
        log(f"  {name} B={RAGGED_ENVS} {tuple(got.shape)}: card == CPU bitwise, "
            f"flipped-pixel self-check caught")
    t0 = time.perf_counter()
    head_d = map_fields(lambda x: x[:16], st)
    head_c = map_fields(lambda x: x[:16], cpu)
    for pov in (False, True):
        got = env.get_frame(head_d, params, tile_size=32, agent_pov=pov).cpu()
        want = env.get_frame(head_c, params, tile_size=32, agent_pov=pov)
        if mismatches(got, want) or got.shape[1] != 32 * (7 if pov else 8):
            raise AssertionError(f"get_frame(tile_size=32, agent_pov={pov}) card != CPU")
    log(f"  get_frame tile 32, B=16, whole grid and POV: card == CPU bitwise "
        f"({time.perf_counter() - t0:.1f} s with the 32-pixel atlas)")


def atlas_gather_bound_ms(flat: torch.Tensor, tile: int) -> tuple[float, dict]:
    """Least time of the atlas gather: the frames written once and the
    indices read once at 4 bytes each (int32 holds every one of the
    NUM_VARIANTS * NUM_CODES rows), over HBM bandwidth (no arithmetic to
    speak of).  The atlas itself (``atlas_bytes``, reported) is left out:
    it fits in L2 and stays there across calls."""
    from minigrid_tpu_torch.ops import render as R

    out = flat.numel() * tile * tile * 3
    atlas = R.NUM_VARIANTS * R.NUM_CODES * tile * tile * 3
    nbytes = out + flat.numel() * 4
    return nbytes / HBM_BYTES_PER_S * 1e3, {"bytes": nbytes, "frame_bytes": out,
                                            "atlas_bytes": atlas}


def drive_wrappers(dev, counters: dict, card: str) -> dict:
    """Phase 4f: each WRAPPED walk at B=4096 (the JAX strategy, launch
    counts) and card == CPU at B=64; the OTHER_WRAPPED and ReseedWrapper
    card == CPU; the renders bitwise on a ragged batch; then the RGB walks'
    rates beside the symbolic one, the atlas gather against its bound,
    tools/benchmark and a tools/battery row.  Returns what PERF.md reads."""
    import minigrid_tpu_torch
    from minigrid_tpu_torch.core import rng
    from minigrid_tpu_torch.core.state import map_fields
    from minigrid_tpu_torch.ops import obs_gather
    from minigrid_tpu_torch.ops import render as R
    from minigrid_tpu_torch.parallel.vector import VectorEnv
    from minigrid_tpu_torch.tools import battery, bench, benchmark
    from minigrid_tpu_torch.utils.convert import state_to_numpy

    out = {"seconds": {}, "ulp": {}, "rates": {}}
    walks = {}
    for i, (name, env_id, wrapper, kwargs, strategy, refill, gathers) in enumerate(WRAPPED):
        t0 = time.perf_counter()
        venv = VectorEnv(make_wrapped(env_id, wrapper, kwargs), NUM_ENVS, device=dev)
        if (venv.reset_strategy, venv.pool_refill) != (strategy, refill):
            raise AssertionError(f"{name}: strategy {venv.reset_strategy}/"
                                 f"{venv.pool_refill}, the JAX package picks "
                                 f"{strategy}/{refill}")
        walk = wrapped_walk(dev, counters, venv, seed=1100 + i, gathers=gathers)
        walks[name] = walk
        leaves = obs_leaves(walk["obs"])
        image = walk["obs"]["image"]
        p = venv.params
        v = kwargs.get("agent_view_size", p.agent_view_size)
        shape = {"RGB partial HWC": (NUM_ENVS, 7 * TILE, 7 * TILE, 3),
                 "RGB partial CHW": (NUM_ENVS, 3, 7 * TILE, 7 * TILE),
                 "RGB full": (NUM_ENVS, p.height * TILE, p.width * TILE, 3)}.get(
                     name, (NUM_ENVS, v, v, 3))
        if tuple(image.shape) != shape or image.dtype != torch.uint8:
            raise AssertionError(f"{name}: image {tuple(image.shape)} {image.dtype}")
        if not image.is_contiguous():
            raise AssertionError(f"{name}: the frames are not contiguous")
        if "Bonus" in name:
            counts = walk["state"].envs.counts if hasattr(walk["state"], "envs") \
                else walk["state"].counts
            inner = walk["state"].envs.inner if hasattr(walk["state"], "envs") \
                else walk["state"].inner
            # one count a step since each env's own reset
            if not torch.equal(counts.flatten(1).sum(1).int(), inner.step_count):
                raise AssertionError(f"{name}: counts do not sum to the step count")
            if not (0 < walk["reward"][0] and walk["reward"][1] <= 2.0):
                raise AssertionError(f"{name}: bonus rewards {walk['reward']}")
        elif "RGB" not in name and not bool((image[..., 0] <= 33).all()):
            raise AssertionError(f"{name}: image types out of range")
        ends64, ulp = wrapped_card_matches_cpu(
            dev, lambda: make_wrapped(env_id, wrapper, kwargs,
                                      max_steps=WRAPPED_CPU_EPISODE), seed=1200 + i)
        out["ulp"][name] = ulp
        out["seconds"][name] = time.perf_counter() - t0
        log(f"  {name} ({wrapper} over {env_id}): {venv.reset_strategy}/"
            f"{venv.pool_refill} as the JAX package picks; {WRAPPED_STEPS} steps at "
            f"B={NUM_ENVS}: {walk['ends']} ends, launches {walk['launches']} "
            f"({gathers} gather(s) an observation), leaves "
            f"{[(n, tuple(t.shape)) for n, t in leaves]}, rewards in "
            f"[{walk['reward'][0]}, {walk['reward'][1]}]; B={WRAPPED_CPU_ENVS} card == "
            f"CPU ({ends64} ends; floats {ulp} ulp apart); {out['seconds'][name]:.1f} s")
    # the gather at the wrapper's view sizes, on the 16x16 walks' states
    out["gather"] = {}
    for name, v in (("view 3", 3), ("view 11", 11)):
        st = walks[name]["state"]
        inputs = {"grid": st.grid, "pos": st.agent_pos, "dir": st.agent_dir, "view": v}
        check_zoo_gather(obs_gather, st, v, f"{DOORKEY_16} V={v}", True)
        times = time_gather(obs_gather, inputs)
        bound, by, work = gather_bound_ms(inputs)
        out["gather"][v] = {**times, "bound_ms": bound, "bound_by": by}
        log(f"  obs_gather B={NUM_ENVS} 16x16 V={v} ({DOORKEY_16} states): kernel "
            f"{times['ms'] * 1e3:.2f} us, plain {times['plain_ms'] * 1e3:.2f} us, "
            f"torch.gather {times['library_ms'] * 1e3:.2f} us, bound {bound * 1e3:.3f} us "
            f"({by}; {work}), {bound / times['ms']:.3f} of the bound; bitwise, "
            f"flipped-bit self-check caught [{card}]")

    t0 = time.perf_counter()
    for i, (wrapper, env_id, kwargs) in enumerate(OTHER_WRAPPED):
        ends64, ulp = wrapped_card_matches_cpu(
            dev, lambda: make_wrapped(env_id, wrapper, kwargs,
                                      max_steps=WRAPPED_CPU_EPISODE), seed=1300 + i)
        label = wrapper + (f"({kwargs})" if kwargs else "")
        out["ulp"][label] = ulp
        log(f"  {label} over {env_id}: B={WRAPPED_CPU_ENVS} card == CPU, "
            f"{WRAPPED_STEPS} steps ({ends64} ends; floats {ulp} ulp apart)")
    # ReseedWrapper: its resets on both devices cycle the same seeds
    from minigrid_tpu_torch.wrappers import ReseedWrapper

    devices = (dev, torch.device("cpu"))
    wrapped = [ReseedWrapper(minigrid_tpu_torch.make(ENV_ID), seeds=[5, 6, 7])
               for _ in devices]
    for k in range(4):
        (g_obs, g_st), (c_obs, c_st) = (w.reset(device=d) for w, d in zip(wrapped, devices))
        same_fields(state_to_numpy(g_st), state_to_numpy(c_st), f"ReseedWrapper reset {k} ")
        if any(mismatches(a.cpu(), b) for (_, a), (_, b) in
               zip(obs_leaves(g_obs), obs_leaves(c_obs))):
            raise AssertionError(f"ReseedWrapper reset {k}: obs differs card vs CPU")
    log("  ReseedWrapper: 4 resets cycling 3 seeds, card == CPU")
    out["seconds"]["other wrappers"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    check_renders(dev)
    out["seconds"]["renders"] = time.perf_counter() - t0

    # -- timings --
    t0 = time.perf_counter()
    for label, venv in (
            ("symbolic", minigrid_tpu_torch.make_vec(ENV_ID, NUM_ENVS, device=dev)),
            ("RGB partial HWC", VectorEnv(make_wrapped(ENV_ID, "RGBImgPartialObsWrapper",
                                                       {}), NUM_ENVS, device=dev)),
            ("RGB partial CHW", VectorEnv(make_wrapped(
                ENV_ID, "RGBImgPartialObsWrapper", {"channels_first": True}),
                NUM_ENVS, device=dev))):
        rate = bench.measure_steps(venv, WRAPPED_TIMED_STEPS)
        out["rates"][label] = rate
        log(f"  {ENV_ID} B={NUM_ENVS} {label} obs: {rate['env_steps_per_sec']:.0f} "
            f"env-steps/s, {rate['us_per_step']:.1f} us/step ({rate['strategy']}, "
            f"predrawn, best of 2 x {WRAPPED_TIMED_STEPS} steps) [{card}]")

    params = minigrid_tpu_torch.make(ENV_ID).default_params
    flat = R.pov_indices(walks["RGB partial HWC"]["state"], params)
    atlas = R.get_atlas(TILE, dev)
    rows = atlas.reshape(R.NUM_VARIANTS * R.NUM_CODES, -1)
    bound_ms, work = atlas_gather_bound_ms(flat, TILE)
    out["atlas_gather"] = {"bound_ms": bound_ms, **work}
    index_ms = gpu_time_ms(lambda: rows.index_select(0, flat.reshape(-1)))
    out["atlas_gather"]["index_select_ms"] = index_ms
    for cf in (False, True):
        ms = gpu_time_ms(lambda: R.tile_frames(atlas, flat, cf))
        out["atlas_gather"]["chw_ms" if cf else "hwc_ms"] = ms
        log(f"  atlas gather B={NUM_ENVS} V={VIEW} T={TILE} "
            f"{'CHW' if cf else 'HWC'} (index_select + layout copy): {ms * 1e3:.2f} us, "
            f"bound {bound_ms * 1e3:.3f} us (bytes; {work}), "
            f"{bound_ms / ms:.3f} of the bound [{card}]")
    log(f"  atlas row gather alone (index_select): {index_ms * 1e3:.2f} us [{card}]")

    bm = benchmark.benchmark("MiniGrid-LavaGapS7-v0", num_resets=20, num_frames=200,
                             tile_size=32, num_envs=NUM_ENVS, vector_steps=32, device=dev)
    out["benchmark"] = bm
    log(f"  tools/benchmark MiniGrid-LavaGapS7-v0 (20 resets, 200 frames at tile 32, "
        f"B={NUM_ENVS} x 32 steps): reset {bm['reset_ms']:.3f} ms, full render "
        f"{bm['render_fps']:.0f} FPS, RGB partial step {bm['rgb_partial_step_fps']:.0f} "
        f"FPS, {bm['vector_env_steps_per_sec']:.0f} env-steps/s [{card}]")
    if not battery.device_kernel_gate(device=dev):
        raise AssertionError("tools/battery's gate did not run on the card")
    row = battery.run_spec(f"{ENV_ID}:obs=rgb_chw,steps=64,device={dev}")
    out["battery"] = row
    log(f"  tools/battery {ENV_ID} obs=rgb_chw: {row['steps_per_sec']} env-steps/s, "
        f"gather {row['gather_impl']} [{card}]")
    out["seconds"]["timings"] = time.perf_counter() - t0
    return out


# -- phase 4g: the learner --------------------------------------------------------

def learner_small_run(dev, kind: str, mesh=None) -> dict:
    """One small learner run of ``kind`` on ``dev`` with a float32 network
    from one key: ``ppo`` (one PPO update on DoorKey-8x8 at a 10-step limit,
    its rollout kept; over ``mesh`` when given), ``rnn`` (one RecurrentPPO
    update on MemoryS7 at a 6-step limit) or ``bc`` (``bc_train`` on a numpy
    dataset).  Returns the trajectory, the metrics and the parameters before
    (PPO) and after it (this rank's slices over a mesh), on the CPU."""
    import numpy as np

    import minigrid_tpu_torch
    from minigrid_tpu_torch import rl
    from minigrid_tpu_torch.core import rng

    cfg = rl.PPOConfig(**LEARNER_SMALL)
    traj, placement = {}, None
    if kind in ("ppo", "rnn"):
        if kind == "ppo":
            env = minigrid_tpu_torch.make(ENV_ID, max_steps=LEARNER_SMALL_LIMIT)
            trainer = rl.PPO(env, None, cfg, device=dev, mesh=mesh, network=rl.ActorCritic(
                env.num_actions, dtype=torch.float32))
        else:
            env = minigrid_tpu_torch.make(RNN_LEARNER, max_steps=RNN_SMALL_LIMIT)
            trainer = rl.RecurrentPPO(env, None, cfg, device=dev,
                                      network=rl.RecurrentActorCritic(
                                          env.num_actions, dtype=torch.float32))
        runner = trainer.init(rng.PRNGKey(0, dev))
        init = {n: p.detach().cpu().clone()
                for n, p in runner.train_state.model.named_parameters()}
        _, traj = trainer.rollout(runner)
        runner, metrics = trainer.update(runner)
        model, lr = runner.train_state.model, cfg.lr
        placement = getattr(trainer, "param_placement", None)
    else:
        r = np.random.default_rng(0)
        image = np.stack([r.integers(0, 11, (96, 7, 7)), r.integers(0, 6, (96, 7, 7)),
                          r.integers(0, 3, (96, 7, 7))], axis=-1).astype(np.uint8)
        data = {"obs": {"image": image, "direction": r.integers(0, 4, 96).astype(np.int32),
                        "mission": r.integers(0, 3, (96, 4)).astype(np.int32)},
                "action": (image[:, 3, 5, 0] % 7).astype(np.int32)}
        data = {"obs": {k: torch.from_numpy(v).to(dev) for k, v in data["obs"].items()},
                "action": torch.from_numpy(data["action"]).to(dev)}
        bc = rl.BCConfig(batch_size=16, num_steps=BC_SMALL_STEPS)
        model, metrics = rl.bc_train(minigrid_tpu_torch.make(ENV_ID), data, bc,
                                     rng.PRNGKey(3, dev),
                                     network=rl.ActorCritic(dtype=torch.float32),
                                     device=dev)
        lr, init = bc.lr, None

    def cpu(tree):
        return {k: cpu(v) if isinstance(v, dict) else v.detach().cpu()
                for k, v in tree.items()}

    return {"traj": cpu(traj), "metrics": cpu(metrics), "lr": lr, "init": init,
            "placement": placement,
            "params": {n: p.detach().cpu() for n, p in model.named_parameters()}}


def compare_learner_runs(got: dict, want: dict, what: str) -> dict:
    """A card run against the CPU run, at the CPU tests' tolerances: the
    trajectory's observations, actions, reward bits and flags equal, values
    and log-probs within LEARNER_VALUE_ATOL; metrics within
    LEARNER_METRIC_RTOL (accuracy within one sample of a BC batch); every
    parameter within a tenth of one step's learning rate, each within
    LEARNER_PARAM_REL_L2 of how far it moved.  Returns the largest errors."""
    errs = {"value": 0.0, "metric": 0.0, "param": 0.0}
    traj_got, traj_want = dict(got["traj"]), dict(want["traj"])
    for k, v in traj_got.pop("obs", {}).items():
        if mismatches(v, traj_want["obs"][k]):
            raise AssertionError(f"{what}: rollout obs {k} differs card vs CPU")
    traj_want.pop("obs", None)
    for k, v in traj_got.items():
        w = traj_want[k]
        if k in ("value", "log_prob", "trunc_value"):
            err = float((v - w).abs().max())
            errs["value"] = max(errs["value"], err)
            if err > LEARNER_VALUE_ATOL:
                raise AssertionError(f"{what}: rollout {k} off by {err} card vs CPU")
        elif mismatches(v.view(torch.int32) if v.dtype == torch.float32 else v,
                        w.view(torch.int32) if w.dtype == torch.float32 else w):
            raise AssertionError(f"{what}: rollout {k} differs card vs CPU")
    for k, v in got["metrics"].items():
        w = want["metrics"][k].to(v.dtype)
        if k == "accuracy":
            ok = bool(((v - w).abs() <= 1 / 16 + 1e-6).all())
        else:
            err = float(((v.double() - w.double()).abs()
                         / w.double().abs().clamp(min=1e-3)).max())
            errs["metric"] = max(errs["metric"], err)
            ok = err <= LEARNER_METRIC_RTOL
        if not ok or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{what}: metric {k} {v} card, {w} CPU")
    for n, p in got["params"].items():
        diff = (p - want["params"][n]).abs()
        errs["param"] = max(errs["param"], float(diff.max()))
        if float(diff.max()) > 0.1 * got["lr"]:
            raise AssertionError(f"{what}: parameter {n} off by {float(diff.max())}")
        if want["init"] is not None:
            moved = float((want["params"][n] - want["init"][n]).norm())
            if float((p - want["params"][n]).norm()) > LEARNER_PARAM_REL_L2 * moved:
                raise AssertionError(f"{what}: {n} off card vs CPU by more than "
                                     f"{LEARNER_PARAM_REL_L2} of its move")
    return errs


def learner_card_matches_cpu(dev, kinds=("ppo", "rnn", "bc")) -> dict:
    """Phase 4g (a): each small learner run on the card and on the CPU from
    the same key, TF32 off (cuDNN's default convolutions round their inputs
    to TF32).  Returns each run's largest errors."""
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        for kind in kinds:
            card_run = learner_small_run(dev, kind)
            cpu_run = learner_small_run(torch.device("cpu"), kind)
            out[kind] = compare_learner_runs(card_run, cpu_run, f"learner {kind}")
        return out
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def trace_device(fn) -> dict:
    """``fn()`` under ``torch.profiler`` (CUDA activity): wall seconds, the
    device's busy seconds (kernels, copies and fills summed from the raw
    trace events; a key_averages() summary of a trace this long takes
    minutes), its idle share and the kernel launches."""
    from torch.profiler import ProfilerActivity, profile

    from minigrid_tpu_torch.tools.bench import LAUNCH_CALLS

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_ns, launches = 0, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            busy_ns += e.duration_ns()
        elif e.name() in LAUNCH_CALLS:
            launches += 1
    return {"wall_s": wall, "busy_s": busy_ns / 1e9,
            "idle_share": 1 - busy_ns / 1e9 / wall, "launches": launches}


def finite_metrics(metrics: dict, what: str) -> dict:
    values = {k: float(v) for k, v in metrics.items()}
    bad = [k for k, v in values.items() if v != v or abs(v) == float("inf")]
    if bad:
        raise AssertionError(f"{what}: metrics not finite: {bad}")
    return values


def zero_counts(counters: dict) -> None:
    """Count the launches of ``counters``' kernels from here (after a sync)."""
    torch.cuda.synchronize()
    for name in counters:
        counters[name] = trace.launches(name)


def read_counts(counters: dict) -> dict:
    """The launches of each of ``counters``' kernels since :func:`zero_counts`."""
    return {name: trace.launches(name) - start for name, start in counters.items()}


def drive_learner(dev, counters: dict, card: str) -> dict:
    """Phase 4g: (a) the small learner runs card == CPU; (b) PPO at
    examples/train_ppo.py's width on DoorKey-8x8 with the default bf16
    ActorCritic, LEARNER_UPDATES timed updates (rollout, GAE, optimize) with
    the launch counts zeroed before each, then one traced; (c) one pooled
    update with the bulk refill; (d) one RecurrentPPO update at
    examples/train_rnn_ppo.py's config; (e) behavior cloning on a dataset from
    a rollout of (b)'s policy, then evaluate_policy.  Returns what PERF.md
    reads."""
    import warnings

    import minigrid_tpu_torch
    from minigrid_tpu_torch import rl
    from minigrid_tpu_torch.core import rng
    from minigrid_tpu_torch.parallel.vector import VectorEnv

    out = {"seconds": {}}
    t0 = time.perf_counter()
    errs = learner_card_matches_cpu(dev)
    out["seconds"]["card == CPU"] = time.perf_counter() - t0
    out["card_vs_cpu"] = errs
    log(f"  (a) card == CPU, float32 networks, TF32 off: PPO {ENV_ID} and RecurrentPPO "
        f"{RNN_LEARNER} B={LEARNER_SMALL['num_envs']} T={LEARNER_SMALL['num_steps']} "
        f"{LEARNER_SMALL['update_epochs']}x{LEARNER_SMALL['num_minibatches']}, bc_train "
        f"{BC_SMALL_STEPS} steps: rollouts equal, largest errors {errs} "
        f"({out['seconds']['card == CPU']:.1f} s)")

    # (b) the slice at full width
    t_b = time.perf_counter()
    env = minigrid_tpu_torch.make(ENV_ID)
    cfg = rl.PPOConfig(**LEARNER, num_updates=LEARNER_UPDATES + 1)
    trainer = rl.PPO(env, None, cfg, device=dev)
    runner = trainer.init(rng.PRNGKey(0, dev))
    model = runner.train_state.model
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != LEARNER_PARAMS or model.dtype != torch.bfloat16:
        raise AssertionError(f"the default ActorCritic has {n_params} parameters, "
                             f"dtype {model.dtype}")
    before = [p.detach().clone() for p in model.parameters()]
    steps_per_update = cfg.update_epochs * cfg.num_minibatches
    b, t = cfg.num_envs, cfg.num_steps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rows = []
    for u in range(LEARNER_UPDATES):
        zero_counts(counters)
        watch = u == 1  # the second update: count the host syncs inside it
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if watch:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                t0 = time.perf_counter()
                runner, traj = trainer.rollout(runner)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                batch = trainer.advantages(runner, traj)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                runner, metrics = trainer.optimize(runner, batch)
                torch.cuda.synchronize()
                t3 = time.perf_counter()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        if watch:
            syncs = [str(w.message).splitlines()[0] for w in caught
                     if "synchroniz" in str(w.message)]
            if syncs:  # the fused DoorKey engine reads nothing back either
                raise AssertionError(f"update 2 read the device {len(syncs)} times: "
                                     f"{syncs[:3]}")
        launches = read_counts(counters)
        if launches["obs_gather"] != 2 * t or launches["fused_step"]:
            raise AssertionError(f"update {u + 1}: launches {launches}, expected "
                                 f"{2 * t} obs_gather (obs and final_obs a step)")
        if runner.train_state.step != (u + 1) * steps_per_update:
            raise AssertionError(f"update {u + 1}: {runner.train_state.step} optimizer steps")
        values = finite_metrics(metrics, f"update {u + 1}")
        row = {"rollout_s": t1 - t0, "gae_s": t2 - t1, "optimize_s": t3 - t2,
               "update_s": t3 - t0, "launches": launches, "metrics": values}
        rows.append(row)
        log(f"  (b) update {u + 1}: {row['update_s']:.3f} s (rollout {row['rollout_s']:.3f}, "
            f"GAE {row['gae_s']:.4f}, optimize {row['optimize_s']:.3f}); obs_gather "
            f"{launches['obs_gather']} launches, optimizer step "
            f"{runner.train_state.step}; loss {values['loss']:.5f}, entropy "
            f"{values['entropy']:.5f}, episodes {values['episodes']:.0f}, return "
            f"{values['mean_return']:.4f} [{card}]")
    peak = torch.cuda.max_memory_allocated()
    if all(torch.equal(a, p) for a, p in zip(before, model.parameters())):
        raise AssertionError("the parameters did not move")
    timed = rows[1:]
    rate = len(timed) * b * t / sum(r["update_s"] for r in timed)
    trace = trace_device(lambda: trainer.update(runner))
    out.update(rows=rows, env_steps_per_s=rate, peak_bytes=peak, trace=trace)
    out["seconds"]["full width"] = time.perf_counter() - t_b
    log(f"  (b) PPO {ENV_ID} B={b} T={t} {cfg.update_epochs}x{cfg.num_minibatches}, bf16 "
        f"ActorCritic ({n_params:,} parameters): {rate:.0f} env-steps/s through the "
        f"loop (updates 2-{LEARNER_UPDATES}), peak memory {peak / 2**20:.1f} MiB; "
        f"update {LEARNER_UPDATES + 1} under torch.profiler: {trace['wall_s']:.3f} s wall, "
        f"device busy {trace['busy_s']:.3f} s, idle share {trace['idle_share']:.4f}, "
        f"{trace['launches']} launches; no host sync inside update 2 "
        f"({out['seconds']['full width']:.1f} s) [{card}]")

    # (c) one pooled update with the bulk refill
    t0 = time.perf_counter()
    penv = minigrid_tpu_torch.make(POOLED_LEARNER)
    pcfg = rl.PPOConfig(**POOLED_LEARNER_CFG, num_updates=1)
    ptrainer = rl.PPO(penv, None, pcfg, device=dev)
    if ptrainer.venv.reset_strategy != "pooled":
        raise AssertionError(f"{POOLED_LEARNER}: strategy {ptrainer.venv.reset_strategy}")
    prunner = ptrainer.init(rng.PRNGKey(1, dev))
    zero_counts(counters)
    t1 = time.perf_counter()
    prunner, pmetrics = ptrainer.update(prunner)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t1
    launches = read_counts(counters)
    values = finite_metrics(pmetrics, POOLED_LEARNER)
    tick = int(prunner.env_state.tick)
    if tick != pcfg.num_steps or launches["obs_gather"] != 2 * pcfg.num_steps:
        raise AssertionError(f"{POOLED_LEARNER}: tick {tick}, launches {launches}")
    n_fresh, n_stale = int(prunner.env_state.n_fresh), int(prunner.env_state.n_stale)
    out["pooled"] = {"update_s": seconds, "window": ptrainer.venv.pool_refill,
                     "n_fresh": n_fresh, "n_stale": n_stale}
    out["seconds"]["pooled"] = time.perf_counter() - t0
    log(f"  (c) PPO {POOLED_LEARNER} B={pcfg.num_envs} T={pcfg.num_steps} pooled, window "
        f"{ptrainer.venv.pool_refill}, refill_period {pcfg.refill_period}: one update "
        f"{seconds:.3f} s, tick {tick}, obs_gather {launches['obs_gather']} launches, "
        f"auto-resets fresh {n_fresh} stale {n_stale}, episodes {values['episodes']:.0f} "
        f"[{card}]")

    # (d) one recurrent update
    t0 = time.perf_counter()
    renv = minigrid_tpu_torch.make(RNN_LEARNER)
    rcfg = rl.PPOConfig(**RNN_LEARNER_CFG)
    rtrainer = rl.RecurrentPPO(renv, None, rcfg, device=dev)
    rrunner = rtrainer.init(rng.PRNGKey(1, dev))
    zero_counts(counters)
    t1 = time.perf_counter()
    initial = rrunner.carry
    rrunner, rtraj = rtrainer.rollout(rrunner)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    rbatch = rtrainer.advantages(rrunner, rtraj)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    rrunner, rmetrics = rtrainer.optimize(rrunner, rbatch, initial)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    launches = read_counts(counters)
    values = finite_metrics(rmetrics, RNN_LEARNER)
    rsteps = rcfg.update_epochs * rcfg.num_minibatches
    if launches["obs_gather"] != rcfg.num_steps or rrunner.train_state.step != rsteps:
        raise AssertionError(f"{RNN_LEARNER}: launches {launches}, "
                             f"{rrunner.train_state.step} optimizer steps")
    out["rnn"] = {"update_s": t4 - t1, "rollout_s": t2 - t1, "gae_s": t3 - t2,
                  "optimize_s": t4 - t3}
    out["seconds"]["rnn"] = time.perf_counter() - t0
    log(f"  (d) RecurrentPPO {RNN_LEARNER} B={rcfg.num_envs} T={rcfg.num_steps} "
        f"{rcfg.update_epochs}x{rcfg.num_minibatches}: one update {t4 - t1:.3f} s "
        f"(rollout {t2 - t1:.3f}, GAE {t3 - t2:.4f}, optimize {t4 - t3:.3f}), "
        f"{rcfg.num_envs * rcfg.num_steps / (t4 - t1):.0f} env-steps/s, obs_gather "
        f"{launches['obs_gather']} launches, loss {values['loss']:.5f} [{card}]")

    # (e) behavior cloning on a rollout of (b)'s greedy policy
    t0 = time.perf_counter()
    venv = VectorEnv(env, BC_ENVS, device=dev)
    obs, st = venv.reset(rng.PRNGKey(5, dev))
    frames, actions = [], []
    with torch.no_grad():
        for _ in range(BC_STEPS):
            logits, _ = model(obs)
            action = torch.argmax(logits, dim=-1).to(torch.int32)
            frames.append({k: v.cpu().numpy() for k, v in obs.items()})
            actions.append(action.cpu().numpy())
            obs, st, *_ = venv.step(st, action)
    demos = [(None, [{k: f[k][i] for k in f} for f in frames], [a[i] for a in actions])
             for i in range(BC_ENVS)]
    ds = rl.pack_bc_dataset(demos, device=dev)
    if tuple(ds["action"].shape) != (BC_ENVS * BC_STEPS,):
        raise AssertionError(f"BC dataset of {tuple(ds['action'].shape)} actions")
    t1 = time.perf_counter()
    bc_cfg = rl.BCConfig()
    bc_model, bc_metrics = rl.bc_train(env, ds, bc_cfg, rng.PRNGKey(6, dev), device=dev)
    loss = bc_metrics["loss"].cpu()
    bc_seconds = time.perf_counter() - t1
    first, last = float(loss[:10].mean()), float(loss[-50:].mean())
    if not bool(torch.isfinite(loss).all()) or not last < first:
        raise AssertionError(f"bc_train: loss {first} over the first 10 steps, {last} "
                             f"over the last 50")
    zero_counts(counters)
    ev = rl.evaluate_policy(env, bc_model, rng.PRNGKey(7, dev),
                            num_episodes=BC_EVAL_EPISODES, max_steps=BC_EVAL_STEPS,
                            device=dev)
    launches = read_counts(counters)
    if not BC_EVAL_EPISODES * 2 <= launches["obs_gather"] <= BC_EVAL_EPISODES * (
            BC_EVAL_STEPS + 1):
        raise AssertionError(f"evaluate_policy: launches {launches}")
    out["bc"] = {"train_s": bc_seconds, "loss_first": first, "loss_last": last,
                 "accuracy_last": float(bc_metrics["accuracy"][-50:].mean()),
                 "evaluate": ev}
    out["seconds"]["bc"] = time.perf_counter() - t0
    log(f"  (e) bc_train on {BC_ENVS}x{BC_STEPS} (obs, greedy action) pairs of (b)'s "
        f"policy, batch {bc_cfg.batch_size}, {bc_cfg.num_steps} steps: {bc_seconds:.3f} s, "
        f"loss {first:.4f} -> {last:.4f}, accuracy {out['bc']['accuracy_last']:.3f}; "
        f"evaluate_policy {BC_EVAL_EPISODES} episodes capped at {BC_EVAL_STEPS} steps: "
        f"{ev}, obs_gather {launches['obs_gather']} launches [{card}]")
    return out


# -- phase 4h: the multi-device layer ------------------------------------------------

def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _rank_start(device: str) -> torch.device:
    """A rank's device.  On the CPU (a rehearsal of the phase, where no
    kernel can launch) the plain gathers count as the kernel's launches."""
    from minigrid_tpu_torch.ops import obs_gather

    dev = torch.device(device)
    if dev.type == "cpu":
        plain = obs_gather.gather_view_plain

        def counted(*args):
            trace.launched("obs_gather")
            return plain(*args)

        obs_gather.gather_view = counted
    return dev


def _digest(*tensors) -> str:
    import hashlib

    m = hashlib.sha256()
    for t in tensors:
        m.update(t.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return m.hexdigest()


def _walk_digest(obs: dict, reward, term, trunc, rows=slice(None)) -> str:
    return _digest(*(obs[k][rows] for k in ("image", "direction", "mission")),
                   reward[rows].view(torch.int32), term[rows], trunc[rows])


def _local_ring(state, lo: int, hi: int, num_envs: int):
    """The rows and ring slots of ``[lo, hi)`` of an unsharded pooled state,
    in a rank's local layout, with the counters zeroed (a rank counts its own
    resets)."""
    from minigrid_tpu_torch.core.state import map_fields

    def ring(x):
        return torch.cat([x[lo:hi], x[num_envs + lo:num_envs + hi]])

    zero = torch.zeros_like(state.n_fresh)
    return state.replace(envs=map_fields(lambda x: x[lo:hi], state.envs),
                         pool=map_fields(ring, state.pool), fresh=ring(state.fresh),
                         n_fresh=zero, n_stale=zero)


def mesh_sizes() -> dict:
    """Phase 4h's sizes, handed to the ranks (a fresh process each)."""
    return {"num_envs": NUM_ENVS, "steps": MESH_STEPS, "episode": MESH_EPISODE,
            "pool_refill": POOL_REFILL, "period": REFILL_PERIOD, "learner": LEARNER,
            "updates": MESH_UPDATES, "ranks": MESH_RANKS}


def mesh_walk(venv, key, steps: int, period: int, rows=None) -> tuple[list, object]:
    """``steps`` pooled steps (consume, then a bulk refill of ``period``
    windows every ``period`` steps) from ``split(key)``; returns each step's
    digest (of the whole batch, or of each ``rows`` slice) and the final
    state."""
    from minigrid_tpu_torch.core import rng

    key, k_reset = rng.split(key).unbind(0)
    _, state = venv.reset(k_reset)
    keys = rng.split(key, steps)
    shard = (venv.lo, venv.hi)
    digests = []
    for t in range(steps):
        action = rng.randint(keys[t], (venv.num_envs,), 0, venv.env.num_actions, rows=shard)
        obs, state, reward, term, trunc, _ = venv.step_nofill(state, action)
        if (t + 1) % period == 0:
            state = venv.refill(state, period)
        if rows is not None:
            digests.append([_walk_digest(obs, reward, term, trunc, r) for r in rows])
        else:
            digests.append(_walk_digest(obs, reward, term, trunc))
    return digests, state


def _rank_env_walk(device: str, sz: dict) -> dict:
    """Phase 4h (a) on one rank: the ShardedVectorEnv walk, its launches."""
    import torch.distributed as dist

    import minigrid_tpu_torch
    from minigrid_tpu_torch.core import rng
    from minigrid_tpu_torch.parallel.sharding import ShardedVectorEnv
    from minigrid_tpu_torch.utils.checkpoint import state_hash

    dev = _rank_start(device)
    env = minigrid_tpu_torch.make(ENV_ID, max_steps=sz["episode"])
    venv = ShardedVectorEnv(env, sz["num_envs"], device=dev, reset_strategy="pooled",
                            pool_refill=sz["pool_refill"])
    _sync(dev)
    before = trace.launches("obs_gather")
    t0 = time.perf_counter()
    digests, state = mesh_walk(venv, rng.PRNGKey(11, dev), sz["steps"], sz["period"])
    _sync(dev)
    seconds = time.perf_counter() - t0
    launches = trace.launches("obs_gather") - before
    zero = torch.zeros_like(state.n_fresh)
    return {"rank": dist.get_rank(), "shard": venv.shard, "digests": digests,
            "state_hash": state_hash(state.replace(n_fresh=zero, n_stale=zero)),
            "ring": venv.ring_counts(state), "tick": int(state.tick),
            "launches": launches, "seconds": seconds}


def _rank_rollout(device: str, sz: dict) -> dict:
    """Phase 4h (b) on one rank: ``sharded_rollout``'s totals and launches."""
    import minigrid_tpu_torch
    from minigrid_tpu_torch.core import rng
    from minigrid_tpu_torch.parallel.sharding import sharded_rollout

    dev = _rank_start(device)
    env = minigrid_tpu_torch.make(ENV_ID, max_steps=sz["episode"])
    _sync(dev)
    before = trace.launches("obs_gather")
    totals = sharded_rollout(env, None, rng.PRNGKey(12, dev), sz["num_envs"], sz["steps"],
                             device=dev)
    return {"totals": totals, "launches": trace.launches("obs_gather") - before}


def _timed_all_reduce(dev, seconds: list):
    """``rl.ppo.reduce_gradients`` with the device synced around it, its
    seconds added to ``seconds[0]``: the gradient all-reduce's share of
    optimize (the syncs slow the update they watch: a separate update)."""
    from minigrid_tpu_torch.rl import ppo

    inner = ppo.reduce_gradients

    def timed(*args):
        _sync(dev)
        t0 = time.perf_counter()
        out = inner(*args)
        _sync(dev)
        seconds[0] += time.perf_counter() - t0
        return out

    return inner, timed


def ppo_phases(trainer, runner, dev) -> tuple:
    """One update timed by phase (rollout, GAE, optimize): (runner, traj,
    metrics, seconds)."""
    _sync(dev)
    t0 = time.perf_counter()
    runner, traj = trainer.rollout(runner)
    _sync(dev)
    t1 = time.perf_counter()
    batch = trainer.advantages(runner, traj)
    _sync(dev)
    t2 = time.perf_counter()
    runner, metrics = trainer.optimize(runner, batch)
    _sync(dev)
    t3 = time.perf_counter()
    return runner, traj, metrics, {"rollout_s": t1 - t0, "gae_s": t2 - t1,
                                   "optimize_s": t3 - t2, "update_s": t3 - t0}


def _rank_ppo(device: str, sz: dict, watch_syncs: bool) -> dict:
    """Phase 4h (c) and (e) on one rank: ``PPO(mesh=pod_mesh())`` at
    LEARNER's width, ``sz["updates"]`` updates timed by phase with the launch count
    zeroed before each, then one more with the gradient all-reduce timed.
    With ``watch_syncs`` the second update runs under
    ``torch.cuda.set_sync_debug_mode`` and its host syncs are returned."""
    import warnings

    import torch.distributed as dist

    import minigrid_tpu_torch
    from minigrid_tpu_torch import rl
    from minigrid_tpu_torch.core import rng
    from minigrid_tpu_torch.parallel.multihost import pod_mesh
    from minigrid_tpu_torch.rl import ppo

    dev = _rank_start(device)
    env = minigrid_tpu_torch.make(ENV_ID)
    updates = sz["updates"]
    cfg = rl.PPOConfig(**sz["learner"], num_updates=updates + 1)
    trainer = rl.PPO(env, None, cfg, device=dev, mesh=pod_mesh(tp=1))
    runner = trainer.init(rng.PRNGKey(0, dev))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    rows, first_actions, syncs = [], None, None
    for u in range(updates):
        _sync(dev)
        before = trace.launches("obs_gather")
        watch = watch_syncs and u == 1 and dev.type == "cuda"
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if watch:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                runner, traj, metrics, seconds = ppo_phases(trainer, runner, dev)
            finally:
                if watch:
                    torch.cuda.set_sync_debug_mode(0)
        if watch:  # the mode's own notice ("... is a prototype feature") is no sync
            syncs = [str(w.message).splitlines()[0] for w in caught
                     if "called a synchronizing" in str(w.message)]
        if u == 0:
            first_actions = traj["action"]
        rows.append({**seconds, "launches": trace.launches("obs_gather") - before,
                     "metrics": {k: float(v) for k, v in metrics.items()}})
    reduce_s = [0.0]
    inner, ppo.reduce_gradients = _timed_all_reduce(dev, reduce_s)
    try:
        runner, _, _, seconds = ppo_phases(trainer, runner, dev)
    finally:
        ppo.reduce_gradients = inner
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    return {"rank": dist.get_rank(), "backend": dist.get_backend(), "rows": rows,
            "shard": (trainer.venv.lo, trainer.venv.hi), "first_actions": first_actions,
            "syncs": syncs, "all_reduce_s": reduce_s[0], "timed_optimize_s":
            seconds["optimize_s"], "peak_bytes": peak, "steps": runner.train_state.step}


def _rank_tp_small(device: str, sz: dict) -> dict:
    """Phase 4h (d) on one rank: the small float32 update over ``dp=1 x
    tp=2``, TF32 off; this rank's parameter slices and their placement."""
    from minigrid_tpu_torch.parallel.multihost import pod_mesh

    dev = _rank_start(device)
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    return learner_small_run(dev, "ppo", mesh=pod_mesh(tp=sz["ranks"]))


def _rank_mesh_phase(device: str, sz: dict) -> dict:
    """Everything phase 4h runs on the ranks that share the card."""
    return {"walk": _rank_env_walk(device, sz), "rollout": _rank_rollout(device, sz),
            "ppo": _rank_ppo(device, sz, watch_syncs=False), "tp": _rank_tp_small(device, sz)}


def drive_multi_device(dev, card: str) -> dict:
    """Phase 4h: (a) ``ShardedVectorEnv`` on MESH_RANKS gloo ranks sharing
    the card, DoorKey-8x8 at B=NUM_ENVS pooled POOL_REFILL/REFILL_PERIOD for
    MESH_STEPS steps at MESH_EPISODE-step episodes, every step's rows and the
    final state bitwise the unsharded card run's, ``obs_gather`` launched on
    every rank every step; (b) ``sharded_rollout``'s totals against the
    unsharded ``rollout``; (c) ``dp=2`` PPO at LEARNER's width, update 1
    against the unsharded update 1 (MESH_ACTION_AGREEMENT,
    MESH_ENTROPY_RTOL), update 2 timed by phase, the gradient all-reduce
    timed in a third, peak memory per rank; (d) the small float32 update over
    ``dp=1 x tp=2`` against the unsharded one at the card == CPU tolerances;
    (e) one rank on an NCCL group: PPO at LEARNER's width, no host sync in
    its second update but the per-epoch count reads; (f)
    ``tools/bench_sharded`` with one rank.  Returns what PERF.md reads."""
    import minigrid_tpu_torch
    from minigrid_tpu_torch import rl
    from minigrid_tpu_torch.core import rng
    from minigrid_tpu_torch.parallel.multihost import spawn
    from minigrid_tpu_torch.parallel.vector import VectorEnv, rollout
    from minigrid_tpu_torch.tools import bench_sharded
    from minigrid_tpu_torch.utils.checkpoint import state_hash
    from minigrid_tpu_torch.utils.convert import unshard_params

    out = {"seconds": {}}
    device = str(dev)
    t0 = time.perf_counter()
    ranks = spawn(_rank_mesh_phase, MESH_RANKS, (device, mesh_sizes()), backend="gloo")
    out["seconds"]["gloo ranks"] = time.perf_counter() - t0
    b = NUM_ENVS // MESH_RANKS
    shards = [(r * b, (r + 1) * b) for r in range(MESH_RANKS)]

    # (a) the walk against the unsharded one
    env = minigrid_tpu_torch.make(ENV_ID, max_steps=MESH_EPISODE)
    venv = VectorEnv(env, NUM_ENVS, reset_strategy="pooled", pool_refill=POOL_REFILL,
                     device=dev)
    digests, state = mesh_walk(venv, rng.PRNGKey(11, dev), MESH_STEPS, REFILL_PERIOD,
                               [slice(lo, hi) for lo, hi in shards])
    for r, rank in enumerate(ranks):
        walk = rank["walk"]
        if tuple(walk["shard"]) != shards[r]:
            raise AssertionError(f"rank {r} holds rows {walk['shard']}")
        bad = [t for t in range(MESH_STEPS) if walk["digests"][t] != digests[t][r]]
        if bad:
            raise AssertionError(f"rank {r}'s rows differ from the unsharded walk at steps "
                                 f"{bad[:5]}")
        if walk["state_hash"] != state_hash(_local_ring(state, *shards[r], NUM_ENVS)):
            raise AssertionError(f"rank {r}'s final state differs from the unsharded one")
        if (tuple(walk["ring"]) != (int(state.n_fresh), int(state.n_stale))
                or walk["tick"] != int(state.tick)):
            raise AssertionError(f"rank {r}: ring {walk['ring']} tick {walk['tick']}, "
                                 f"unsharded {int(state.n_fresh)}, {int(state.n_stale)}, "
                                 f"{int(state.tick)}")
        if walk["launches"] != MESH_STEPS + 1:  # one an observation, the reset's too
            raise AssertionError(f"rank {r}: obs_gather launched {walk['launches']} times "
                                 f"in a reset and {MESH_STEPS} steps")
    n_fresh, n_stale = int(state.n_fresh), int(state.n_stale)
    if n_fresh + n_stale < NUM_ENVS:
        raise AssertionError(f"only {n_fresh + n_stale} auto-resets in the walk")
    out["walk"] = {"seconds": [r["walk"]["seconds"] for r in ranks],
                   "launches": [r["walk"]["launches"] for r in ranks],
                   "n_fresh": n_fresh, "n_stale": n_stale}
    log(f"  (a) ShardedVectorEnv {ENV_ID} B={NUM_ENVS} on {MESH_RANKS} gloo ranks sharing "
        f"the card ({b} envs each), pooled {POOL_REFILL}/{REFILL_PERIOD}, max_steps "
        f"{MESH_EPISODE}: {MESH_STEPS} steps bitwise the unsharded card run (every step's "
        f"rows, the final state), auto-resets fresh {n_fresh} stale {n_stale} summed over "
        f"the ranks, tick {int(state.tick)}; obs_gather launches per rank "
        f"{out['walk']['launches']}; walk seconds per rank "
        f"{[round(s, 3) for s in out['walk']['seconds']]} (digests included) [{card}]")

    # (b) sharded_rollout against the unsharded rollout
    _, traj = rollout(env, None, rng.PRNGKey(12, dev), NUM_ENVS, MESH_STEPS, device=dev)
    want = (NUM_ENVS * MESH_STEPS, float(traj["reward"].double().sum()),
            int((traj["terminated"] | traj["truncated"]).sum()))
    for r, rank in enumerate(ranks):
        steps, reward, dones = rank["rollout"]["totals"]
        if (steps, dones) != (want[0], want[2]) or abs(reward - want[1]) > 1e-3:
            raise AssertionError(f"rank {r}: sharded_rollout {rank['rollout']['totals']}, "
                                 f"unsharded {want}")
        if rank["rollout"]["launches"] != MESH_STEPS + 1:
            raise AssertionError(f"rank {r}: sharded_rollout launched obs_gather "
                                 f"{rank['rollout']['launches']} times")
    out["rollout"] = {"totals": ranks[0]["rollout"]["totals"],
                      "launches": [r["rollout"]["launches"] for r in ranks]}
    log(f"  (b) sharded_rollout B={NUM_ENVS} T={MESH_STEPS} on {MESH_RANKS} ranks: "
        f"{ranks[0]['rollout']['totals']} on every rank, unsharded {want}; obs_gather "
        f"launches per rank {out['rollout']['launches']} [{card}]")

    # (c) dp=2 PPO at full width against the unsharded update 1
    t_c = time.perf_counter()
    trainer = rl.PPO(minigrid_tpu_torch.make(ENV_ID), None,
                     rl.PPOConfig(**LEARNER, num_updates=MESH_UPDATES + 1), device=dev)
    runner = trainer.init(rng.PRNGKey(0, dev))
    _, traj, metrics, base = ppo_phases(trainer, runner, dev)
    base_metrics = finite_metrics(metrics, "unsharded update 1")
    got_actions = torch.cat([torch.as_tensor(r["ppo"]["first_actions"]) for r in ranks], 1)
    agree = float((got_actions == traj["action"].cpu()).float().mean())
    rows = [r["ppo"]["rows"] for r in ranks]
    for r, rank_rows in enumerate(rows):
        for u, row in enumerate(rank_rows):
            finite_metrics(row["metrics"], f"dp=2 rank {r} update {u + 1}")
            if row["metrics"] != rows[0][u]["metrics"]:
                raise AssertionError(f"update {u + 1}: rank {r} reports other metrics")
            if row["launches"] != 2 * LEARNER["num_steps"]:
                raise AssertionError(f"rank {r} update {u + 1}: obs_gather launched "
                                     f"{row['launches']} times")
    entropy = rows[0][0]["metrics"]["entropy"]
    if (agree < MESH_ACTION_AGREEMENT
            or abs(entropy - base_metrics["entropy"]) > MESH_ENTROPY_RTOL * abs(
                base_metrics["entropy"])):
        raise AssertionError(f"dp=2 update 1: {agree:.4f} of the actions agree, entropy "
                             f"{entropy} against {base_metrics['entropy']}")
    rel = {k: abs(rows[0][0]["metrics"][k] - v) / max(abs(v), 1e-6)
           for k, v in base_metrics.items()}
    timed = [rank_rows[-1] for rank_rows in rows]
    out["ppo"] = {"unsharded": base, "rows": rows, "agreement": agree, "metric_rel": rel,
                  "peak_bytes": [r["ppo"]["peak_bytes"] for r in ranks],
                  "all_reduce_s": [r["ppo"]["all_reduce_s"] for r in ranks],
                  "timed_optimize_s": [r["ppo"]["timed_optimize_s"] for r in ranks]}
    out["seconds"]["unsharded update"] = time.perf_counter() - t_c
    log(f"  (c) PPO {ENV_ID} B={LEARNER['num_envs']} T={LEARNER['num_steps']} "
        f"{LEARNER['update_epochs']}x{LEARNER['num_minibatches']} bf16, dp={MESH_RANKS} "
        f"(gloo, one card): update 1 {agree:.4f} of the actions equal to the unsharded "
        f"update's, metrics equal on every rank, relative differences "
        f"{ {k: float(f'{v:.3g}') for k, v in rel.items()} }; update {MESH_UPDATES} per "
        f"rank: " + "; ".join(
            f"{t['update_s']:.3f} s (rollout {t['rollout_s']:.3f}, GAE {t['gae_s']:.4f}, "
            f"optimize {t['optimize_s']:.3f})" for t in timed)
        + f"; the unsharded update 1 {base['update_s']:.3f} s (rollout "
        f"{base['rollout_s']:.3f}, GAE {base['gae_s']:.4f}, optimize "
        f"{base['optimize_s']:.3f}); gradient all-reduce (gloo) "
        f"{[round(s, 4) for s in out['ppo']['all_reduce_s']]} s of optimize "
        f"{[round(s, 3) for s in out['ppo']['timed_optimize_s']]} s in a third, synced "
        f"update; obs_gather {rows[0][-1]['launches']} launches per rank an update; peak "
        f"memory per rank {[round(p / 2**20, 1) for p in out['ppo']['peak_bytes']]} MiB "
        f"[{card}]")

    # (d) dp=1 x tp=2, small and float32, against the unsharded run
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want_small = learner_small_run(dev, "ppo")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    tp_ranks = [r["tp"] for r in ranks]
    got_small = dict(tp_ranks[0])
    got_small["params"] = unshard_params(
        [{n: torch.as_tensor(v) for n, v in r["params"].items()} for r in tp_ranks],
        [r["placement"] for r in tp_ranks])
    got_small["traj"] = {k: ({n: torch.as_tensor(a) for n, a in v.items()}
                             if isinstance(v, dict) else torch.as_tensor(v))
                         for k, v in got_small["traj"].items()}
    got_small["metrics"] = {k: torch.as_tensor(v) for k, v in got_small["metrics"].items()}
    sharded = sorted(n for n, s in tp_ranks[0]["placement"].items() if s is not None)
    errs = compare_learner_runs(got_small, want_small, "dp=1 x tp=2")
    out["tp"] = {"errors": errs, "sharded": sharded}
    log(f"  (d) the small float32 PPO update over dp=1 x tp={MESH_RANKS} (gloo, one card, "
        f"TF32 off) against the unsharded one: rollouts equal, largest errors {errs}; "
        f"{len(sharded)} of {len(tp_ranks[0]['placement'])} parameters sharded [{card}]")

    # (e) one rank on an NCCL group
    t0 = time.perf_counter()
    nccl = spawn(_rank_ppo, 1, (device, {**mesh_sizes(), "updates": 2}, True),
                 backend="nccl" if dev.type == "cuda" else "gloo")[0]
    out["seconds"]["nccl rank"] = time.perf_counter() - t0
    syncs = nccl["syncs"] or []
    if dev.type == "cuda" and len(syncs) != LEARNER["update_epochs"]:
        raise AssertionError(f"the NCCL update read the device {len(syncs)} times, expected "
                             f"{LEARNER['update_epochs']} (the per-epoch counts): "
                             f"{syncs[:6]}")
    out["nccl"] = nccl
    row = nccl["rows"][-1]
    log(f"  (e) PPO at the same width on a one-rank {nccl['backend']} group: update 2 "
        f"{row['update_s']:.3f} s (rollout {row['rollout_s']:.3f}, GAE {row['gae_s']:.4f}, "
        f"optimize {row['optimize_s']:.3f}), {len(syncs)} host syncs in it (the per-epoch "
        f"count reads); gradient all-reduce {nccl['all_reduce_s']:.4f} s of optimize "
        f"{nccl['timed_optimize_s']:.3f} s in a third, synced update; peak memory "
        f"{nccl['peak_bytes'] / 2**20:.1f} MiB [{card}]")

    # (f) the weak-scaling sweep with the ranks this host holds
    t0 = time.perf_counter()
    sweep = bench_sharded.sweep(ENV_ID, [1, 2], NUM_ENVS, MESH_BENCH_STEPS, verbose=False,
                                device=dev.type)
    out["bench_sharded"] = sweep
    out["seconds"]["bench_sharded"] = time.perf_counter() - t0
    if [r["n_devices"] for r in sweep][:1] != [1]:
        raise AssertionError(f"bench_sharded rows {sweep}")
    log(f"  (f) tools/bench_sharded {ENV_ID} {NUM_ENVS} envs/device x {MESH_BENCH_STEPS} "
        f"steps: {sweep} ({bench_sharded.available(dev.type)} device(s) here) [{card}]")
    log(f"  phase 4h seconds: { {k: round(v, 1) for k, v in out['seconds'].items()} }")
    return out


# -- phase 4i: the host surface ---------------------------------------------------

def optional_packages() -> dict:
    """Each optional package's version, or None where it does not import."""
    import importlib

    out = {}
    for name in OPTIONAL_PACKAGES:
        try:
            out[name] = getattr(importlib.import_module(name), "__version__", "present")
        except ImportError:
            out[name] = None
    return out


def same_obs(a: dict, b: dict, what: str) -> None:
    """Two observations of one env agree: numpy leaves in dtype and value,
    the mission string, or tensor leaves of a batch."""
    if set(a) != set(b):
        raise AssertionError(f"{what}: observation keys differ")
    for k, x in a.items():
        y = b[k]
        if isinstance(x, torch.Tensor):
            x, y = x.cpu().numpy(), y.cpu().numpy()
        if isinstance(x, str) or isinstance(y, str):
            ok = x == y
        else:
            ok = (type(x) is type(y) and x.dtype == y.dtype and x.shape == y.shape
                  and bool((x == y).all()))
        if not ok:
            raise AssertionError(f"{what}: observation {k} differs card vs CPU")


def drive_exact_resets(dev, counters: dict, card: str) -> dict:
    """Phase 4i (b): ``reset_exact`` on the card for every supported id at
    EXACT_SEEDS: its two halves timed apart (``host_level``, then
    ``finalize_level`` with a sync), one ``obs_gather`` launch a reset, then
    the public ``reset_exact`` on the card (one launch again) and on the CPU,
    state and observation bitwise."""
    import minigrid_tpu_torch
    from minigrid_tpu_torch.utils import exact
    from minigrid_tpu_torch.utils.convert import state_to_numpy

    cpu = torch.device("cpu")
    ids = minigrid_tpu_torch.registered_ids()
    refused = tuple(sorted(i for i in ids if not exact.supported(minigrid_tpu_torch.make(i))))
    if refused != EXACT_UNSUPPORTED:
        raise AssertionError(f"reset_exact refuses {refused}, expected {EXACT_UNSUPPORTED}")
    supported = [i for i in ids if i not in EXACT_UNSUPPORTED]
    if len(supported) != EXACT_SUPPORTED:
        raise AssertionError(f"{len(supported)} supported ids, expected {EXACT_SUPPORTED}")
    for env_id in refused:
        try:
            exact.reset_exact(minigrid_tpu_torch.make(env_id), 0, device=dev)
        except NotImplementedError:
            continue
        raise AssertionError(f"reset_exact of {env_id} did not raise")
    ms = {"MiniGrid": ([], []), "BabyAI": ([], [])}
    launches_total = 0
    for env_id in supported:
        env = minigrid_tpu_torch.make(env_id)
        params = env.default_params
        fam = "BabyAI" if env_id.startswith("BabyAI-") else "MiniGrid"
        for seed in EXACT_SEEDS:
            what = f"reset_exact {env_id} seed {seed}"
            zero_counts(counters)
            t0 = time.perf_counter()
            level = exact.host_level(env, seed, params)
            t1 = time.perf_counter()
            obs, state = exact.finalize_level(env, level, seed, params, dev)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            launches = read_counts(counters)
            if launches != {"obs_gather": 1, "fused_step": 0}:
                raise AssertionError(f"{what}: launches {launches}, expected one obs_gather")
            zero_counts(counters)
            pub_obs, pub_state = exact.reset_exact(env, seed, params, device=dev)
            if read_counts(counters)["obs_gather"] != 1:
                raise AssertionError(f"{what}: the public reset_exact launched "
                                     f"{read_counts(counters)}")
            launches_total += 2
            if pub_state.grid.device.type != dev.type:
                raise AssertionError(f"{what}: the state is not on the card")
            cpu_obs, cpu_state = exact.reset_exact(env, seed, params, device=cpu)
            card_fields = state_to_numpy(state)
            same_fields(card_fields, state_to_numpy(cpu_state), what + " ")
            same_fields(state_to_numpy(pub_state), card_fields, what + " public ")
            same_obs(obs, cpu_obs, what)
            same_obs(pub_obs, obs, what + " public")
            ms[fam][0].append((t1 - t0) * 1e3)
            ms[fam][1].append((t2 - t1) * 1e3)
    out = {"launches": launches_total, "resets": 2 * len(supported) * len(EXACT_SEEDS)}
    for fam, (host, device) in ms.items():
        out[fam] = {"host_ms": statistics.median(host), "device_ms": statistics.median(device),
                    "host_max_ms": max(host), "device_max_ms": max(device), "resets": len(host)}
        log(f"  (b) {fam}: {len(host)} resets, host generation median "
            f"{out[fam]['host_ms']:.3f} ms (max {out[fam]['host_max_ms']:.3f}), device "
            f"finalize and observation median {out[fam]['device_ms']:.3f} ms (max "
            f"{out[fam]['device_max_ms']:.3f}) [{card}]")
    log(f"  (b) reset_exact: {len(supported)} ids x {len(EXACT_SEEDS)} seeds, card == CPU "
        f"bitwise (state and observation), one obs_gather launch a reset "
        f"({launches_total} in all); the four dataset ids refused")
    return out


class CoreAdapter:
    """The Gymnasium adapter's functional core, for a machine without
    gymnasium: ``reset_exact`` (or ``Env.reset`` on the threefry key stream
    when unseeded) and ``Env.step`` on a batch of one, the outputs read back
    in one copy (``utils/convert.to_host``), ``hash`` of row 0, and a
    pickle round trip through ``state_to_numpy``."""

    def __init__(self, env_id: str, device):
        import minigrid_tpu_torch
        from minigrid_tpu_torch.core import rng

        self.env = minigrid_tpu_torch.make(env_id)
        self.params = self.env.default_params
        self.device = torch.device(device)
        self.num_actions = self.env.num_actions
        self.key = rng.PRNGKey(0, self.device)
        self.state = None

    def _host(self, obs: dict, more: tuple = ()) -> tuple:
        from minigrid_tpu_torch.utils.convert import to_host

        arrays = to_host([v[0] for v in obs.values()] + list(more))
        out = {k: a for k, a in zip(obs, arrays)}
        out["mission"] = self.env.mission_text(out["mission"])
        return out, arrays[len(obs):]

    def reset(self, seed=None):
        from minigrid_tpu_torch.core import rng
        from minigrid_tpu_torch.utils.exact import reset_exact

        if seed is not None:
            obs, self.state = reset_exact(self.env, seed, self.params, self.device)
            self.key = rng.PRNGKey(seed, self.device)
        else:
            self.key, k = rng.split(self.key).unbind(0)
            obs, self.state = self.env.reset(k[None], self.params, self.device)
        return self._host(obs)[0], {}

    def step(self, action: int):
        a = torch.full((1,), int(action), dtype=torch.int32, device=self.device)
        obs, self.state, r, te, tr, info = self.env.step(self.state, a, self.params)
        out, (r, te, tr) = self._host(obs, (r, te, tr))
        return out, float(r[0]), bool(te[0]), bool(tr[0]), dict(info)

    def hash(self) -> str:
        from minigrid_tpu_torch.core.state import map_fields
        from minigrid_tpu_torch.utils.checkpoint import state_hash

        return state_hash(map_fields(lambda t: t[0], self.state))

    def clone(self) -> "CoreAdapter":
        """A copy through pickled host numpy, back on this device."""
        import pickle

        from minigrid_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

        other = object.__new__(CoreAdapter)
        other.__dict__.update(self.__dict__)
        other.state = state_from_numpy(pickle.loads(pickle.dumps(state_to_numpy(self.state))),
                                       self.device)
        return other


def gym_episode(make, env_id: str, steps: int, counters: dict | None) -> dict:
    """One exact-seed episode walk: reset(seed=GYM_SEED), ``steps`` steps of
    numpy-seeded actions, an unseeded reset after an episode ends.  Records
    every output and hash; with ``counters``, the launches."""
    import numpy as np

    env = make(env_id)
    base = env.unwrapped if hasattr(env, "unwrapped") else env
    n = env.action_space.n if hasattr(env, "action_space") else env.num_actions
    actions = np.random.default_rng(GYM_SEED).integers(0, n, steps)
    if counters is not None:
        zero_counts(counters)
    obs, _ = env.reset(seed=GYM_SEED)
    rec = {"env": base, "outputs": [(obs, base.hash())], "resets": 1}
    for a in actions:
        obs, reward, term, trunc, _ = env.step(int(a))
        rec["outputs"].append((obs, np.float32(reward).tobytes(), term, trunc, base.hash()))
        if term or trunc:
            rec["outputs"].append((env.reset()[0], base.hash()))
            rec["resets"] += 1
    if counters is not None:
        torch.cuda.synchronize()
        rec["launches"] = read_counts(counters)
    return rec


def same_outputs(got: list, want: list, what: str) -> None:
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} records against {len(want)}")
    for t, (g, w) in enumerate(zip(got, want)):
        same_obs(g[0], w[0], f"{what} record {t}")
        if g[1:] != w[1:]:
            raise AssertionError(f"{what} record {t}: reward bits, flags or hash differ "
                                 f"card vs CPU: {g[1:]} against {w[1:]}")


def step_costs(env) -> dict:
    """One adapter step on the card under ``torch.profiler`` (its launches)
    and under ``torch.cuda.set_sync_debug_mode`` (its host syncs)."""
    import warnings

    traced = trace_device(lambda: env.step(2))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            env.step(1)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "called a synchronizing" in str(w.message)]
    return {"step_launches": traced["launches"], "step_syncs": len(syncs)}


def median_step_us(env, steps: int) -> float:
    """Median wall µs of ``env.step`` (each returns host values, so each
    call ends synced)."""
    import numpy as np

    actions = np.random.default_rng(GYM_SEED + 1).integers(0, 7, steps)
    times = []
    for a in actions:
        t0 = time.perf_counter()
        _, _, term, trunc, _ = env.step(int(a))
        times.append((time.perf_counter() - t0) * 1e6)
        if term or trunc:
            env.reset()
    return statistics.median(times)


def drive_gym_episodes(dev, counters: dict, card: str, has_gym: bool) -> dict:
    """Phase 4i (c): GYM_EPISODES through ``gym.make("minigrid_tpu_torch/<id>",
    exact_seed=True)`` on the card and on the CPU (without gymnasium, through
    the adapter's functional core, :class:`CoreAdapter`), every output and
    hash equal, ``obs_gather`` once per reset and step; a pickle round trip
    on the card; a step's launches, host syncs and median time on both
    devices."""
    import pickle

    if has_gym:
        import gymnasium as gym

        from minigrid_tpu_torch import gym_compat

        gym_compat.register_gym_envs()

        def maker(d):
            return lambda env_id: gym.make(gym_compat.gym_id(env_id), exact_seed=True,
                                           device=d)
    else:
        def maker(d):
            return lambda env_id: CoreAdapter(env_id, d)
    route = "gym.make" if has_gym else "gymnasium absent: the functional core"
    out = {"route": route}
    for env_id, steps in GYM_EPISODES:
        card_rec = gym_episode(maker(dev), env_id, steps, counters)
        cpu_rec = gym_episode(maker("cpu"), env_id, steps, None)
        what = f"(c) {env_id}"
        same_outputs(card_rec["outputs"], cpu_rec["outputs"], what)
        want = {"obs_gather": steps + card_rec["resets"], "fused_step": 0}
        if card_rec["launches"] != want:
            raise AssertionError(f"{what}: launches {card_rec['launches']}, expected {want}")
        env = card_rec["env"]
        clone = pickle.loads(pickle.dumps(env)) if has_gym else env.clone()
        state = clone._state if has_gym else clone.state
        if clone.device.type != dev.type or state.grid.device.type != dev.type:
            raise AssertionError(f"{what}: the unpickled adapter left the card")
        if clone.hash() != env.hash():
            raise AssertionError(f"{what}: the pickle round trip changed the state")
        a, b = clone.step(3), env.step(3)
        same_obs(a[0], b[0], f"{what} after the pickle")
        if a[1:] != b[1:] or clone.hash() != env.hash():
            raise AssertionError(f"{what}: the unpickled adapter steps apart")
        row = {"steps": steps, "resets": card_rec["resets"], "launches": card_rec["launches"]}
        row.update(step_costs(env))
        row["card_us"] = median_step_us(env, GYM_TIMED_STEPS)
        row["cpu_us"] = median_step_us(cpu_rec["env"], GYM_TIMED_STEPS)
        log(f"  (c) {env_id} ({route}): {steps} steps, {row['resets']} resets, card == "
            f"CPU (observations, missions, reward bits, flags, hash), obs_gather "
            f"{row['launches']['obs_gather']}; pickle round trip on the card; a step: "
            f"{row['step_launches']} launches traced, {row['step_syncs']} host syncs, "
            f"median {row['card_us']:.1f} us on the card and {row['cpu_us']:.1f} us on "
            f"the CPU [{card}]")
        out[env_id] = row
    return out


def drive_resume(dev, card: str) -> dict:
    """Phase 4i (d): ``tools/train_ppo`` on the card at RESUME_ENVS x RESUME_STEPS, RESUME_SPLIT
    updates with ``--checkpoint`` then ``--resume``, against their sum
    straight, both legs annealing over the whole run (``--total-updates``),
    cuDNN's deterministic algorithms on.  The runner loaded from the file
    equals the saved one bitwise; the continued run's env state equals the
    straight run's, and its parameters and metrics are within phase 4g's
    card == CPU tolerances."""
    import os
    import tempfile

    import minigrid_tpu_torch
    from minigrid_tpu_torch.core import rng
    from minigrid_tpu_torch.rl import PPO, PPOConfig
    from minigrid_tpu_torch.tools import train_ppo
    from minigrid_tpu_torch.utils.checkpoint import load, max_abs_diff, state_hash

    n, m = RESUME_SPLIT
    args = ["--env", ENV_ID, "--num-envs", str(RESUME_ENVS), "--num-steps",
            str(RESUME_STEPS), "--seed", "0", "--device", str(dev)]
    total = ["--total-updates", str(n + m)]
    flag = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "runner.pt")
            first, first_hist = train_ppo.main(args + total + [
                "--num-updates", str(n), "--checkpoint", path])
            env = minigrid_tpu_torch.make(ENV_ID)
            cfg = PPOConfig(num_envs=RESUME_ENVS, num_steps=RESUME_STEPS, num_updates=n + m)
            trainer = PPO(env, env.default_params, cfg, device=dev)
            loaded = load(path, trainer.init(rng.PRNGKey(1, dev)))
            load_diff = max_abs_diff(loaded, first)
            if load_diff != 0.0:
                raise AssertionError(f"(d) the loaded runner differs from the saved one "
                                     f"by {load_diff}")
            resumed, resumed_hist = train_ppo.main(args + total + [
                "--num-updates", str(m), "--resume", path])
        straight, straight_hist = train_ppo.main(args + ["--num-updates", str(n + m)])
    finally:
        torch.backends.cudnn.deterministic = flag
    if state_hash(resumed.env_state) != state_hash(straight.env_state):
        raise AssertionError("(d) the resumed run's env state differs from the straight run's")
    params = max(float((a - b).detach().abs().max()) for a, b in zip(
        resumed.train_state.model.parameters(), straight.train_state.model.parameters()))
    if params > 0.1 * PPOConfig().lr:
        raise AssertionError(f"(d) parameters off by {params}")
    metric = 0.0
    for got, want in zip(resumed_hist, straight_hist[n:]):
        for k, v in got.items():
            w = want[k].double()
            err = float(((v.double() - w).abs() / w.abs().clamp(min=1e-3)).max())
            metric = max(metric, err)
    if metric > LEARNER_METRIC_RTOL:
        raise AssertionError(f"(d) metrics off by {metric} (relative)")
    whole = max_abs_diff(resumed, straight)
    log(f"  (d) train_ppo {' '.join(args)}: {n} updates + checkpoint, the load "
        f"bitwise; --resume + {m} against {n + m} straight: env state equal, parameters "
        f"{params:.3g} apart, metrics {metric:.3g} (relative), the whole runner "
        f"{whole:.3g} [{card}]")
    return {"load_diff": load_diff, "param_diff": params, "metric_rdiff": metric,
            "runner_diff": whole}


def drive_host_surface(dev, counters: dict, card: str) -> dict:
    """Phase 4i: (a) the optional packages; (b) ``reset_exact`` on every
    supported id; (c) exact-seed ``GymEnv`` episodes; (d) the
    ``train_ppo`` resume.  Returns what PERF.md reads."""
    packages = optional_packages()
    log("  (a) optional packages: " + ", ".join(
        f"{k} {v if v else 'absent'}" for k, v in packages.items()))
    out = {"packages": packages, "seconds": {}}
    t0 = time.perf_counter()
    out["exact"] = drive_exact_resets(dev, counters, card)
    out["seconds"]["exact"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["gym"] = drive_gym_episodes(dev, counters, card, packages["gymnasium"] is not None)
    out["seconds"]["gym"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["resume"] = drive_resume(dev, card)
    out["seconds"]["resume"] = time.perf_counter() - t0
    log(f"  phase 4i seconds: { {k: round(v, 1) for k, v in out['seconds'].items()} }")
    return out


# -- phase 4j: the host tools ----------------------------------------------------

def counted(env, *names: str) -> dict:
    """Count the calls of ``env``'s methods ``names`` (instance attributes
    in front of the class's): -> the live counts."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        def wrapped(*args, _fn=getattr(env, name), _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)
        setattr(env, name, wrapped)
    return calls


def same_demos(got: list, want: list, what: str) -> None:
    """Two demo lists agree: missions, actions, reward bits, targets and
    every observation."""
    import numpy as np

    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} demos against {len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        same = (g[0] == w[0] and g[2] == w[2] and g[5] == w[5]
                and np.asarray(g[3], np.float32).tobytes()
                == np.asarray(w[3], np.float32).tobytes()
                and [int(x) for x in g[4]] == [int(x) for x in w[4]]
                and len(g[1]) == len(w[1]))
        if not same:
            raise AssertionError(f"{what}: demo {i} differs card vs CPU")
        for t, (og, ow) in enumerate(zip(g[1], w[1])):
            same_obs(og, ow, f"{what} demo {i} step {t}")


def drive_oracle(dev, counters: dict, card: str) -> dict:
    """Phase 4j (a): the oracle's demos of HOST_DEMOS on the card (one
    ``obs_gather`` launch per reset and step, asserted) and through
    ``collect`` on the CPU, equal; ``pack_demos`` through ``torch.save`` and
    ``torch.load``."""
    import tempfile

    import minigrid_tpu_torch
    from minigrid_tpu_torch.core import rng
    from minigrid_tpu_torch.tools import generate_demos
    from minigrid_tpu_torch.tools.oracle import OracleAgent

    out = {}
    for env_id, num_demos in HOST_DEMOS:
        env = minigrid_tpu_torch.make(env_id)
        calls = counted(env, "reset", "step")
        zero_counts(counters)
        t0 = time.perf_counter()
        demos = OracleAgent(env, device=dev).generate_demos(rng.PRNGKey(0, dev), num_demos)
        seconds = time.perf_counter() - t0
        launches = read_counts(counters)
        same_demos(demos, generate_demos.collect(env_id, num_demos, seed=0, device="cpu"),
                   f"(a) {env_id}")
        want = {"obs_gather": calls["reset"] + calls["step"], "fused_step": 0}
        if launches != want:
            raise AssertionError(f"(a) {env_id}: launches {launches}, expected {want}")
        packed = generate_demos.pack_demos(demos)
        with tempfile.TemporaryDirectory() as tmp:
            torch.save(packed, f"{tmp}/demos.pt")
            loaded = torch.load(f"{tmp}/demos.pt")
        if loaded["missions"] != packed["missions"] or any(
                not torch.equal(loaded[k], packed[k]) for k in packed if k != "missions"):
            raise AssertionError(f"(a) {env_id}: pack_demos did not round-trip")
        ms = seconds / (calls["reset"] + calls["step"]) * 1e3
        log(f"  (a) {env_id}: {len(demos)} demos of {num_demos} (lengths "
            f"{[len(d[2]) for d in demos]}), card == CPU (missions, actions, reward bits, "
            f"targets, every observation); {calls['reset']} resets and {calls['step']} "
            f"steps, obs_gather {launches['obs_gather']}; {ms:.2f} ms a reset or step "
            f"with its host reads; pack_demos round-trips through torch.save [{card}]")
        out[env_id] = {"demos": len(demos), "resets": calls["reset"],
                       "steps": calls["step"], "ms": ms}
    return out


def drive_profile(dev, counters: dict, card: str) -> dict:
    """Phase 4j (b): ``profile_rollout`` at the main configuration (pooled
    POOL_REFILL/REFILL_PERIOD, B=NUM_ENVS) for PROFILE_STEPS steps with a
    trace: the obs_gather kernel among the trace's kernels, once per
    observation of the traced run."""
    import tempfile

    from minigrid_tpu_torch.tools import profile

    zero_counts(counters)
    with tempfile.TemporaryDirectory() as tmp:
        res = profile.profile_rollout(ENV_ID, NUM_ENVS, PROFILE_STEPS, tmp,
                                      reset_strategy="pooled", pool_refill=POOL_REFILL,
                                      refill_period=REFILL_PERIOD, device=dev)
        rows = profile.top_kernels(tmp, None)
    launches = read_counts(counters)
    want = {"obs_gather": 3 * (PROFILE_STEPS + 1), "fused_step": 0}  # three runs
    if launches != want:
        raise AssertionError(f"(b) launches {launches}, expected {want}")
    if res["kernels"] != rows[:15]:
        raise AssertionError("(b) top_kernels does not read the run's trace")
    gathers = [(rank, row) for rank, row in enumerate(rows, 1)
               if "obs_gather_kernel" in row[0]]
    if [row[2] for _, row in gathers] != [PROFILE_STEPS + 1]:
        raise AssertionError(f"(b) the trace's obs_gather rows: {gathers}")
    rank, (_, gather_ms, _) = gathers[0]
    log(f"  (b) profile_rollout {ENV_ID} B={NUM_ENVS} pooled {POOL_REFILL}/"
        f"{REFILL_PERIOD}, {PROFILE_STEPS} steps: {res['steps_per_sec']:.0f} env-steps/s, "
        f"traced {res['launches_per_step']:.1f} launches a step, device idle share "
        f"{res['device_idle_share']:.3f}; obs_gather_kernel rank {rank} of {len(rows)} "
        f"kernels, {gather_ms:.3f} ms over {PROFILE_STEPS + 1} calls [{card}]")
    for name, ms, calls in rows[:5]:
        log(f"      {ms:9.3f} ms  x{calls:6d}  {name[:90]}")
    return {**{k: res[k] for k in ("steps_per_sec", "launches_per_step",
                                   "device_idle_share")},
            "top5": rows[:5], "gather_rank": rank, "gather_ms": gather_ms}


def drive_autotune(dev, counters: dict, card: str) -> dict:
    """Phase 4j (c): ``autotune`` on the main id at B=NUM_ENVS over its
    AUTOTUNE_STEPS-step rollouts: every candidate measured on the card."""
    from minigrid_tpu_torch.tools import autotune

    cands = autotune.candidates(NUM_ENVS, False)
    zero_counts(counters)
    res = autotune.autotune(ENV_ID, NUM_ENVS, AUTOTUNE_STEPS, device=dev)
    launches = read_counts(counters)
    if [row[0] for row in res["table"]] != [c.label() for c in cands]:
        raise AssertionError(f"(c) not every candidate measured: {res['table']}")
    # each candidate: two runs, each a reset and AUTOTUNE_STEPS steps
    want = {"obs_gather": 2 * (AUTOTUNE_STEPS + 1) * len(cands), "fused_step": 0}
    if launches != want:
        raise AssertionError(f"(c) launches {launches}, expected {want}")
    log(f"  (c) autotune {ENV_ID} B={NUM_ENVS}, {AUTOTUNE_STEPS} steps: {len(cands)} "
        f"candidates measured, best {res['reset_strategy']} (C={res['pool_refill']}, "
        f"K={res['refill_period']}) at {res['steps_per_sec']:.0f} env-steps/s, fresh "
        f"{res['fresh_frac']}; obs_gather {launches['obs_gather']} [{card}]")
    return res


def drive_sweep(dev, counters: dict, card: str) -> dict:
    """Phase 4j (d): ``battery_sweep.main --quick`` on the card into a file
    seeded with every module but SWEEP_MODULES, which its resume rule then
    runs (256 envs x 64 steps): the gate first, then four rows naming the
    card."""
    import contextlib
    import io
    import tempfile

    from minigrid_tpu_torch.tools import battery_sweep

    err = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/sweep.jsonl"
        with open(path, "w") as f:
            for module, _ in battery_sweep.SWEEP:
                if module not in SWEEP_MODULES:
                    f.write(json.dumps({"module": module}) + "\n")
        zero_counts(counters)
        with contextlib.redirect_stderr(err):
            battery_sweep.main([path, "--quick"])
        launches = read_counts(counters)
        with open(path) as f:
            rows = [json.loads(line) for line in f][len(battery_sweep.SWEEP)
                                                    - len(SWEEP_MODULES):]
    if "device kernel gate ok" not in err.getvalue():
        raise AssertionError(f"(d) the gate did not run: {err.getvalue()}")
    kind = torch.cuda.get_device_name(dev)
    if ([r["module"] for r in rows] != list(SWEEP_MODULES)
            or any("error" in r or r["device"] != kind for r in rows)):
        raise AssertionError(f"(d) rows: {rows}")
    # the gate's launch, then two runs of a reset and 64 steps a row; the RGB
    # wrapper's observation gathers twice (its POV render's own view)
    want = 1 + sum(2 * 65 * (2 if r["obs"] == "rgb" else 1) for r in rows)
    if launches != {"obs_gather": want, "fused_step": 0}:
        raise AssertionError(f"(d) launches {launches}, expected {want} obs_gather")
    for r in rows:
        log(f"  (d) sweep {r['module']}: {r['env']} {r['strategy']} "
            f"(refill {r['pool_refill']}, period {r['refill_period']}, obs {r['obs']}) "
            f"{r['num_envs']} envs x {r['steps']} steps: {r['steps_per_sec']} env-steps/s, "
            f"fresh {r['fresh_frac']} [{card}]")
    log(f"  (d) the gate ran first; obs_gather {launches['obs_gather']}")
    return {r["module"]: r["steps_per_sec"] for r in rows}


def drive_docs(dev, counters: dict, card: str) -> dict:
    """Phase 4j (e): ``build_pages`` with a frame of every family on the
    card; DOC_FAMILIES' PNGs and a GIF_FRAMES-frame GIF equal to the CPU's
    byte for byte; ``build_site`` over the pages."""
    import collections
    import os
    import tempfile

    import minigrid_tpu_torch
    from minigrid_tpu_torch.registry import spec
    from minigrid_tpu_torch.tools import gen_docs, gen_site

    families = collections.Counter(spec(i).cls.__name__
                                   for i in minigrid_tpu_torch.registered_ids())
    with tempfile.TemporaryDirectory() as tmp:
        zero_counts(counters)
        t0 = time.perf_counter()
        pages = gen_docs.build_pages(with_images=True, out_dir=f"{tmp}/card", device=dev)
        seconds = time.perf_counter() - t0
        launches = read_counts(counters)
        # a reset, then the frame's highlight (the view's cells) a family
        want = {"obs_gather": 2 * len(families), "fused_step": 0}
        if len(pages) != len(families) or launches != want:
            raise AssertionError(f"(e) {len(pages)} pages, launches {launches}, "
                                 f"expected {want}")
        os.makedirs(f"{tmp}/cpu/img")
        for name in families:  # every other family's frame is there already
            if name not in DOC_FAMILIES:
                open(f"{tmp}/cpu/img/{name}.png", "wb").close()
        gen_docs.build_pages(with_images=True, out_dir=f"{tmp}/cpu", device="cpu")
        for name in DOC_FAMILIES:
            with open(f"{tmp}/card/img/{name}.png", "rb") as a, \
                    open(f"{tmp}/cpu/img/{name}.png", "rb") as b:
                if a.read() != b.read():
                    raise AssertionError(f"(e) {name}.png differs card vs CPU")
        for where in ("card", "cpu"):
            gen_docs.gen_gif("MiniGrid-Empty-5x5-v0", f"{tmp}/{where}.gif",
                             num_frames=GIF_FRAMES, device=dev if where == "card" else "cpu")
        with open(f"{tmp}/card.gif", "rb") as a, open(f"{tmp}/cpu.gif", "rb") as b:
            if a.read() != b.read():
                raise AssertionError("(e) the GIF differs card vs CPU")
        for name, page in pages.items():
            with open(f"{tmp}/card/{name}.md", "w") as f:
                f.write(page)
        site = gen_site.build_site(f"{tmp}/card", f"{tmp}/site")
        if site != len(pages) or not os.path.exists(f"{tmp}/site/index.html"):
            raise AssertionError(f"(e) build_site wrote {site} pages")
    log(f"  (e) build_pages: {len(pages)} pages with a frame each in {seconds:.1f} s "
        f"({seconds / len(pages) * 1e3:.1f} ms a family), obs_gather "
        f"{launches['obs_gather']}; PNGs of {', '.join(DOC_FAMILIES)} and a "
        f"{GIF_FRAMES}-frame GIF card == CPU byte for byte; build_site {site} pages [{card}]")
    return {"pages": len(pages), "seconds": seconds, "site_pages": site}


def drive_manual_control(dev, counters: dict, card: str) -> dict:
    """Phase 4j (f): ``ManualControl`` with a fake window under MANUAL_KEYS
    on the card and on the CPU: every caption and frame equal."""
    import contextlib
    import io

    import numpy as np

    import minigrid_tpu_torch
    from minigrid_tpu_torch.tools.manual_control import ManualControl

    class Window:
        def __init__(self):
            self.images, self.captions, self.handler = [], [], None

        def reg_key_handler(self, handler):
            self.handler = handler

        def show_img(self, img):
            self.images.append(np.asarray(img))

        def set_caption(self, text):
            self.captions.append(text)

    class Key:
        def __init__(self, key):
            self.key = key

    runs = []
    for where in (dev, torch.device("cpu")):
        env = minigrid_tpu_torch.make("MiniGrid-Empty-5x5-v0")
        calls = counted(env, "reset", "step", "get_frame")
        window = Window()
        zero_counts(counters)
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            mc = ManualControl(env, seed=3, window=window, device=where)
            mc.reset()
            for key in MANUAL_KEYS:
                window.handler(Key(key))
        runs.append((window, printed.getvalue(), calls, read_counts(counters)))
    (card_win, card_out, calls, launches), (cpu_win, cpu_out, _, _) = runs
    if (card_win.captions != cpu_win.captions or card_out != cpu_out
            or len(card_win.images) != len(cpu_win.images)
            or any(not np.array_equal(a, b) for a, b in zip(card_win.images, cpu_win.images))):
        raise AssertionError("(f) ManualControl differs card vs CPU")
    want = {"obs_gather": calls["reset"] + calls["step"] + calls["get_frame"], "fused_step": 0}
    if launches != want:
        raise AssertionError(f"(f) launches {launches}, expected {want}")
    log(f"  (f) ManualControl, keys {list(MANUAL_KEYS)}: {len(card_win.images)} frames "
        f"and {len(card_win.captions)} captions card == CPU; obs_gather "
        f"{launches['obs_gather']} (one a reset, step and frame) [{card}]")
    return {"frames": len(card_win.images)}


def drive_smoke(dev, counters: dict, card: str) -> dict:
    """Phase 4j (g): ``tools/smoke.run_smoke`` on the card: the gather check
    over the plain version and the kernel, the lockstep (skipped without the
    reference) and the kernel gate at B=4096."""
    import contextlib
    import io

    from minigrid_tpu_torch.tools import smoke

    zero_counts(counters)
    with contextlib.redirect_stdout(io.StringIO()) as out, \
            contextlib.redirect_stderr(io.StringIO()) as err:
        smoke.run_smoke(device=dev)
    launches = read_counts(counters)
    if out.getvalue().splitlines()[-1:] != ["SMOKE OK"] or "gate ok" not in err.getvalue():
        raise AssertionError(f"(g) run_smoke: {out.getvalue()} {err.getvalue()}")
    if launches != {"obs_gather": 2, "fused_step": 0}:  # the check's and the gate's
        raise AssertionError(f"(g) launches {launches}")
    notes = "; ".join(line.removeprefix("smoke: ") for line in err.getvalue().splitlines())
    log(f"  (g) run_smoke: SMOKE OK ({notes}); obs_gather {launches['obs_gather']} [{card}]")
    return {"lockstep": "lockstep skipped" not in err.getvalue()}


def drive_host_tools(dev, counters: dict, card: str) -> dict:
    """Phase 4j: (a) the oracle and the demos; (b) ``profile_rollout``; (c)
    ``autotune``; (d) the battery sweep; (e) ``gen_docs`` and ``gen_site``;
    (f) ``ManualControl``; (g) ``run_smoke``.  Returns what PERF.md reads."""
    out = {"seconds": {}}
    for part, fn in (("oracle", drive_oracle), ("profile", drive_profile),
                     ("autotune", drive_autotune), ("sweep", drive_sweep),
                     ("docs", drive_docs), ("manual", drive_manual_control),
                     ("smoke", drive_smoke)):
        t0 = time.perf_counter()
        out[part] = fn(dev, counters, card)
        out["seconds"][part] = time.perf_counter() - t0
    log(f"  phase 4j seconds: { {k: round(v, 1) for k, v in out['seconds'].items()} }")
    return out


# -- phase 5: times ---------------------------------------------------------------

def gather_bound_ms(inputs: dict) -> tuple[float, str, dict]:
    """Least time for the window gather on these inputs: the larger of the
    bytes it must move (pose read, in-bounds window words read, window
    written) over HBM bandwidth and its integer operations over the int32
    rate."""
    from minigrid_tpu_torch.core.obs import view_world_coords

    grid, pos, dirs = inputs["grid"], inputs["pos"], inputs["dir"]
    v = inputs.get("view", VIEW)
    b, w, h = grid.shape
    wx, wy = view_world_coords(pos, dirs, v)
    in_bounds = int(((wx >= 0) & (wx < w) & (wy >= 0) & (wy < h)).sum())
    nbytes = b * (2 * 4 + 4) + in_bounds * 4 + b * v * v * 4
    # per view cell: direction selects (4), two coordinates (6), bounds (4),
    # address (2), select (1)
    ops = b * v * v * 17
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), bound_by, {"bytes": nbytes, "int_ops": ops,
                                           "in_bounds_cells": in_bounds}


def time_gather(obs_gather, inputs: dict) -> dict:
    from minigrid_tpu_torch.core.obs import view_world_coords

    grid, pos, dirs = inputs["grid"], inputs["pos"], inputs["dir"]
    v = inputs.get("view", VIEW)
    b, w, h = grid.shape
    kernel_ms = gpu_time_ms(lambda: obs_gather.gather_view(grid, pos, dirs, v))
    plain_ms = gpu_time_ms(lambda: obs_gather.gather_view_plain(grid, pos, dirs, v))
    # library yardstick: one torch.gather over precomputed flat indices into
    # the grid with a grey-wall word appended per env for out-of-bounds cells
    wx, wy = view_world_coords(pos, dirs, v)
    oob = (wx < 0) | (wx >= w) | (wy < 0) | (wy >= h)
    flat = torch.where(oob, w * h, wx * h + wy).reshape(b, v * v).long()
    padded = torch.cat([grid.reshape(b, w * h),
                        torch.full((b, 1), obs_gather.WALL_PACKED, dtype=torch.int32,
                                   device=grid.device)], dim=1)
    lib = torch.gather(padded, 1, flat).reshape(b, v, v)
    if mismatches(lib, obs_gather.gather_view_plain(grid, pos, dirs, v)):
        raise AssertionError("the library yardstick computes another function")
    library_ms = gpu_time_ms(lambda: torch.gather(padded, 1, flat))
    return {"ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms}


def fused_bound_ms(args: tuple, spec, out: tuple) -> tuple[float, str, dict]:
    """Least time for the fused step on these inputs: the larger of the
    bytes it must move and its operations over the int32 rate.

    Bytes: each input read once (the agent row and action; the grid of a
    lane that goes on, only the front cell of one that finishes; the key and
    step index once) and each output written once.  Operations, counted from
    the kernel's code per lane: about 60 for the step and the action tree;
    per view cell about 27 (coordinates, bounds, address, transparency,
    select, unpack); 4 per step of the two occlusion sweeps (2 (V-1) per
    row); for a finished lane 12 per regenerated cell and, where its
    generator draws, 5 threefry hashes; and 3 hashes per step in all.  A
    hash is 20 rounds of add, rotate and xor plus 5 key injections: 80."""
    from minigrid_tpu_torch.ops.fused_step import GEN_EMPTY

    grid, agent, action, key, t = args
    n, w, h = grid.shape
    v = spec.view
    done = int((out[4] | out[5]).sum())
    reads = n * (agent.shape[1] * 4 + 4) + (n - done) * w * h * 4 + done * 4 + 16 + 4
    writes = n * (w * h * 4 + agent.shape[1] * 4 + v * v * 3 + 4 + 1 + 1) + 16 + 4
    hashes = 3 + (5 * done if spec.generator != GEN_EMPTY else 0)
    ops = (n * (60 + v * v * 27 + 8 * v * (v - 1)) + done * w * h * 12
           + hashes * 80)
    t_bytes = (reads + writes) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), bound_by, {"bytes": reads + writes, "int_ops": ops,
                                           "finished_lanes": done}


def time_fused(fused_step, args: tuple, spec) -> dict:
    """Kernel and plain device times; no single PyTorch call computes the
    fused step, so there is no library yardstick."""
    kernel_ms = gpu_time_ms(lambda: fused_step.fused_step(*args, spec))
    plain_ms = gpu_time_ms(lambda: fused_step.fused_step_plain(*args, spec))
    return {"ms": kernel_ms, "plain_ms": plain_ms, "library_ms": None}


def threefry_bound_ms(keys: int, hashes: int, words: int) -> tuple[float, str, dict]:
    """Least time for ``hashes`` threefry hashes under ``keys`` keys: the
    keys read once and ``words`` int64 words a hash written (2 for a split,
    1 for bits) over HBM bandwidth, against HASH_OPS operations a hash over
    the int32 rate."""
    nbytes = keys * 16 + hashes * words * 8
    ops = hashes * HASH_OPS
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), bound_by, {"bytes": nbytes, "int_ops": ops}


def host_us(fn, calls: int = HOST_CALLS) -> float:
    """Host microseconds a call of ``fn`` takes to issue, no sync inside:
    the median of five runs of ``calls`` calls, each drained before the
    next."""
    runs = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(runs)


def time_threefry(threefry) -> list[dict]:
    """Phase 5: per THREEFRY_TIMED shape the kernel's and the plain formula's
    device time (CUDA graphs), the bound, and the host time to issue one
    kernel call and one plain call."""
    from minigrid_tpu_torch.core import rng

    gen = torch.Generator().manual_seed(7)
    out = []
    for what, b, n, kind in THREEFRY_TIMED:
        keys = _key_words(gen, b).cuda()
        if kind == "split":
            def kernel(k=keys, n=n):
                return threefry.split(k, n)

            def plain(k=keys, n=n):
                return torch.stack(rng._hash_iota(k, (n,)), -1)
        else:
            def kernel(k=keys, n=n):
                return threefry.bits(k, (n,))

            def plain(k=keys, n=n):
                w1, w2 = rng._hash_iota(k, (n,))
                return w1 ^ w2
        if mismatches(kernel(), plain()):
            raise AssertionError(f"threefry {what}: kernel != plain on the card")
        bound, bound_by, work = threefry_bound_ms(b, b * n, 2 if kind == "split" else 1)
        rec = {"what": what, "ms": gpu_time_ms(kernel), "plain_ms": gpu_time_ms(plain),
               "bound_ms": bound, "bound_by": bound_by, "work": work,
               "host_us": host_us(kernel), "plain_host_us": host_us(plain, HOST_CALLS // 20),
               "rng_host_us": host_us(lambda k=keys, n=n, kind=kind: getattr(rng, kind)(
                   k, n if kind == "split" else (n,)))}
        out.append(rec)
    return out


def distractors_bound_ms(n: int, cells: int, num: int, all_unique: bool
                         ) -> tuple[float, str, dict]:
    """Least time for ``n`` levels of ``num`` distractors on grids of
    ``cells`` words: each grid read and written once, the keys, poses and
    combo masks read, the pairs and positions written, over HBM bandwidth,
    against the useful hashes (DISTRACTOR_HASHES an object) at HASH_OPS
    operations each over the int32 rate."""
    nbytes = n * (2 * cells * 4 + 16 + 8 + 2 * 30 + 2 * num * 2 * 4)
    ops = n * num * DISTRACTOR_HASHES[all_unique] * HASH_OPS
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), bound_by, {"bytes": nbytes, "int_ops": ops}


def time_distractors(dev) -> list[dict]:
    """Phase 5: GoTo's call (18 objects with duplicates over its builder
    after the doors) at each of DISTRACTORS_TIMED levels: the kernel's and
    the plain loop's device time (CUDA graphs; the loop's hashes on the
    threefry kernel), the bound, and the host time one call of each
    takes."""
    import minigrid_tpu_torch
    from minigrid_tpu_torch.core import rng

    env = minigrid_tpu_torch.make(GOTO)
    p = env.default_params
    out = []
    for n in DISTRACTORS_TIMED:
        k = rng.split(rng.split(rng.PRNGKey(n, dev), n), 5).unbind(1)
        b = env.connect_all(env.place_agent_any(env.init_rooms(k[0], p), k[1], p), k[2])

        def kernel(b=b, key=k[3]):
            return env.add_distractors(b, key, p, num_distractors=18, all_unique=False)

        def plain(b=b, key=k[3]):
            return env._add_distractors_plain(b, key, p, None, None, 18, False, True, None)

        for g, w in zip(_distractor_outputs(kernel()), _distractor_outputs(plain())):
            if mismatches(g, w):
                raise AssertionError(f"distractors B={n}: kernel != plain on the card")
        cells = b["grid"].shape[1] * b["grid"].shape[2]
        bound, bound_by, work = distractors_bound_ms(n, cells, 18, False)
        out.append({"what": f"{GOTO} B={n} 18 objects", "levels": n,
                    "ms": gpu_time_ms(kernel),
                    "plain_ms": gpu_time_ms(plain, per_graph=2, reps=10),
                    "bound_ms": bound, "bound_by": bound_by, "work": work,
                    "host_us": host_us(kernel, HOST_CALLS // 10),
                    "plain_host_us": host_us(plain, 5)})
    return out


def descs_bound_ms(redraws: torch.Tensor, cells: int, locked_mask: bool
                   ) -> tuple[float, str, dict]:
    """Least time for one descriptor call whose lanes redrew ``redraws``
    int32[B, 8] times, on grids of ``cells`` words: each grid (and, without
    implicit unlocking, its locked-room mask) read once, the keys, poses and
    kinds read, the descriptors and redraws written, over HBM bandwidth,
    against the useful hashes (1 + 22 a draw, a lane) at HASH_OPS operations
    each over the int32 rate."""
    n = redraws.shape[0]
    nbytes = n * (cells * (5 if locked_mask else 4) + 2 * 16 + 12 + 16 + 1 + 8 * 4 * 4)
    ops = (redraws.numel() + 22 * int((1 + redraws.long()).sum())) * HASH_OPS
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), bound_by, {"bytes": nbytes, "int_ops": ops}


def time_descs(dev) -> list[dict]:
    """Phase 5: BossLevel's descriptor call at each of DESCS_TIMED levels:
    the kernel's device time (CUDA graphs), the bound, and the host time a
    call takes; the plain loop's time a call on the card (CUDA events, its
    hashes on the threefry kernel, its host reads included: it cannot be
    captured) and its host time."""
    import minigrid_tpu_torch
    from minigrid_tpu_torch.core import rng

    env = minigrid_tpu_torch.make(BOSS)
    out = []
    for n in DESCS_TIMED:
        inputs = descs_inputs(env, rng.split(rng.PRNGKey(n + 1, dev), n))

        def kernel(inputs=inputs):
            return env._rand_objs(*inputs)

        def plain(inputs=inputs):
            return env._rand_objs_plain(*inputs)

        want = plain()
        for g, w in zip(kernel(), want):
            if mismatches(g, w):
                raise AssertionError(f"descs B={n}: kernel != plain on the card")
        plain_ms = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            plain()
            end.record()
            end.synchronize()
            plain_ms.append(start.elapsed_time(end))
        grid = inputs[2]["grid"]
        bound, bound_by, work = descs_bound_ms(want[2], grid.shape[1] * grid.shape[2],
                                               not env.implicit_unlock)
        out.append({"what": f"{BOSS} B={n}", "levels": n,
                    "redraws_max": int(want[2].max()), "redraws_sum": int(want[2].sum()),
                    "ms": gpu_time_ms(kernel), "plain_ms": statistics.median(plain_ms),
                    "bound_ms": bound, "bound_by": bound_by, "work": work,
                    "host_us": host_us(kernel, HOST_CALLS // 10),
                    "plain_host_us": host_us(plain, 5)})
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs on a card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    log("phase 1: card")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"  {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.device_count()} device(s)")

    from minigrid_tpu_torch.ops import _build, fused_step, obs_gather, threefry

    log("phase 2: build")
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"  built {sorted(logs) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, out in logs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"  [{name}] {line.strip()}")
    counters = {"obs_gather": 0, "fused_step": 0}  # each kernel's count when last zeroed

    log("phase 3: kernels against their plain versions on the card")
    err = check_gather_sweep(dev, obs_gather)
    err_dk, inputs = check_gather_doorkey(dev, obs_gather)
    err = max(err, err_dk)
    fused_err, fused_batches = check_fused_kernel(dev, fused_step)
    _, fused_args, fused_spec = fused_batches[0]
    threefry_err = check_threefry_kernel(dev)
    distractors_err = check_distractors_kernel(dev)
    descs_err = check_descs_kernel(dev)

    log("phase 4: the main paths")
    main = drive_main_path(dev, counters)
    goto_hashes = check_goto_hashes(dev)
    check_distractor_levels(dev)
    boss_descs = check_boss_descs(dev)
    card_matches_cpu(dev)
    fused_main = drive_fused_path(dev, counters)
    fused_card_matches_cpu(dev)

    log("phase 4b: the zoo")
    t0 = time.perf_counter()
    zoo = drive_zoo(dev, counters, obs_gather, card)
    err = max(err, zoo["max_abs_err"])
    log(f"  the zoo phase took {time.perf_counter() - t0:.1f} s")

    log("phase 4c: the multi-room families")
    t0 = time.perf_counter()
    rooms = drive_roomgrid(dev, counters, obs_gather, card)
    err = max(err, rooms["max_abs_err"])
    log(f"  the multi-room phase took {time.perf_counter() - t0:.1f} s")

    log("phase 4d: BabyAI")
    t0 = time.perf_counter()
    baby = drive_babyai(dev, counters, obs_gather, card)
    err = max(err, baby["max_abs_err"])
    log(f"  the BabyAI phase took {time.perf_counter() - t0:.1f} s")

    log("phase 4e: BabyAI slice B and the dataset envs")
    t0 = time.perf_counter()
    slice_b = drive_slice_b(dev, counters, obs_gather, card)
    err = max(err, slice_b["max_abs_err"])
    log(f"  the slice B phase took {time.perf_counter() - t0:.1f} s")

    log("phase 4f: the wrappers and the renderer")
    t0 = time.perf_counter()
    drive_wrappers(dev, counters, card)
    log(f"  the wrappers phase took {time.perf_counter() - t0:.1f} s")

    log("phase 4g: the learner")
    t0 = time.perf_counter()
    drive_learner(dev, counters, card)
    log(f"  the learner phase took {time.perf_counter() - t0:.1f} s")

    log("phase 4h: the multi-device layer")
    t0 = time.perf_counter()
    drive_multi_device(dev, card)
    log(f"  the multi-device phase took {time.perf_counter() - t0:.1f} s")

    log("phase 4i: the host surface")
    t0 = time.perf_counter()
    drive_host_surface(dev, counters, card)
    log(f"  the host-surface phase took {time.perf_counter() - t0:.1f} s")

    log("phase 4j: the host tools")
    t0 = time.perf_counter()
    drive_host_tools(dev, counters, card)
    log(f"  the host-tools phase took {time.perf_counter() - t0:.1f} s")

    log("phase 5: times")
    times = time_gather(obs_gather, inputs)
    bound_ms, bound_by, work = gather_bound_ms(inputs)
    log(f"  obs_gather B={NUM_ENVS} 8x8 V={VIEW}: kernel {times['ms'] * 1e3:.2f} us, "
        f"plain {times['plain_ms'] * 1e3:.2f} us, torch.gather "
        f"{times['library_ms'] * 1e3:.2f} us, bound {bound_ms * 1e3:.3f} us "
        f"({bound_by}; {work}), {bound_ms / times['ms']:.3f} of the bound [{card}]")

    mr = zoo["multiroom_inputs"]
    mr_times = time_gather(obs_gather, mr)
    mr_bound, mr_by, mr_work = gather_bound_ms(mr)
    log(f"  obs_gather B={NUM_ENVS} 25x25 V={VIEW} ({MULTIROOM} states): kernel "
        f"{mr_times['ms'] * 1e3:.2f} us, plain {mr_times['plain_ms'] * 1e3:.2f} us, "
        f"torch.gather {mr_times['library_ms'] * 1e3:.2f} us, bound "
        f"{mr_bound * 1e3:.3f} us ({mr_by}; {mr_work}), "
        f"{mr_bound / mr_times['ms']:.3f} of the bound [{card}]")

    for env_id in ("MiniGrid-KeyCorridorS6R3-v0", "MiniGrid-LockedRoom-v0"):
        rg = rooms["inputs"][env_id]
        rg_times = time_gather(obs_gather, rg)
        rg_bound, rg_by, rg_work = gather_bound_ms(rg)
        _, w, h = rg["grid"].shape
        log(f"  obs_gather B={NUM_ENVS} {w}x{h} V={VIEW} ({env_id} states): kernel "
            f"{rg_times['ms'] * 1e3:.2f} us, plain {rg_times['plain_ms'] * 1e3:.2f} us, "
            f"torch.gather {rg_times['library_ms'] * 1e3:.2f} us, bound "
            f"{rg_bound * 1e3:.3f} us ({rg_by}; {rg_work}), "
            f"{rg_bound / rg_times['ms']:.3f} of the bound [{card}]")

    for shape, env_id in (("22x22", "BabyAI-GoTo-v0"), ("4x4", "BabyAI-GoToObjS4-v0"),
                          ("9x5", BABYAI_9X5)):
        bi = baby["inputs"][shape]
        bi_times = time_gather(obs_gather, bi)
        bi_bound, bi_by, bi_work = gather_bound_ms(bi)
        log(f"  obs_gather B={NUM_ENVS} {shape} V={VIEW} ({env_id} states): kernel "
            f"{bi_times['ms'] * 1e3:.2f} us, plain {bi_times['plain_ms'] * 1e3:.2f} us, "
            f"torch.gather {bi_times['library_ms'] * 1e3:.2f} us, bound "
            f"{bi_bound * 1e3:.3f} us ({bi_by}; {bi_work}), "
            f"{bi_bound / bi_times['ms']:.3f} of the bound [{card}]")

    for env_id in (ONE_ROOM_20, DIRECTIONS):
        si = slice_b["inputs"][env_id]
        si_times = time_gather(obs_gather, si)
        si_bound, si_by, si_work = gather_bound_ms(si)
        _, w, h = si["grid"].shape
        log(f"  obs_gather B={NUM_ENVS} {w}x{h} V={si['view']} ({env_id} states): "
            f"kernel {si_times['ms'] * 1e3:.2f} us, plain {si_times['plain_ms'] * 1e3:.2f} "
            f"us, torch.gather {si_times['library_ms'] * 1e3:.2f} us, bound "
            f"{si_bound * 1e3:.3f} us ({si_by}; {si_work}), "
            f"{si_bound / si_times['ms']:.3f} of the bound [{card}]")

    fused_times = time_fused(fused_step, fused_args, fused_spec)
    fused_out = fused_step.fused_step_plain(*fused_args, fused_spec)
    fused_bound, fused_bound_by, fused_work = fused_bound_ms(fused_args, fused_spec,
                                                             fused_out)
    log(f"  fused_step B={NUM_ENVS} 8x8 V={VIEW}: kernel "
        f"{fused_times['ms'] * 1e3:.2f} us, plain {fused_times['plain_ms'] * 1e3:.2f} us, "
        f"no library call, bound {fused_bound * 1e3:.3f} us ({fused_bound_by}; "
        f"{fused_work}), {fused_bound / fused_times['ms']:.3f} of the bound [{card}]")
    where, args, spec = fused_batches[1]  # most lanes regenerate
    regen_ms = gpu_time_ms(lambda: fused_step.fused_step(*args, spec))
    regen_bound = fused_bound_ms(args, spec, fused_step.fused_step_plain(*args, spec))
    log(f"  fused_step on {where}: kernel {regen_ms * 1e3:.2f} us, bound "
        f"{regen_bound[0] * 1e3:.3f} us ({regen_bound[1]}; {regen_bound[2]}) [{card}]")
    args, spec = fused_case(dev, ENV_ID, walk=24, seed=1, num_envs=WIDE_ENVS)
    wide_ms = gpu_time_ms(lambda: fused_step.fused_step(*args, spec))
    wide_bound = fused_bound_ms(args, spec, fused_step.fused_step_plain(*args, spec))
    log(f"  fused_step B={WIDE_ENVS} 8x8 V={VIEW}: kernel {wide_ms * 1e3:.2f} us, bound "
        f"{wide_bound[0] * 1e3:.3f} us ({wide_bound[1]}; {wide_bound[2]}), "
        f"{wide_bound[0] / wide_ms:.3f} of the bound [{card}]")

    threefry_times = time_threefry(threefry)
    for r in threefry_times:
        log(f"  threefry {r['what']}: kernel {r['ms'] * 1e3:.2f} us, plain "
            f"{r['plain_ms'] * 1e3:.2f} us, bound {r['bound_ms'] * 1e3:.4f} us "
            f"({r['bound_by']}; {r['work']}), {r['bound_ms'] / r['ms']:.3f} of the bound; "
            f"host {r['host_us']:.2f} us a wrapper call, {r['rng_host_us']:.2f} us a "
            f"core/rng.py call, {r['plain_host_us']:.1f} us a plain call [{card}]")

    distractors_times = time_distractors(dev)
    for r in distractors_times:
        log(f"  distractors {r['what']}: kernel {r['ms'] * 1e3:.2f} us, plain "
            f"{r['plain_ms'] * 1e3:.2f} us, bound {r['bound_ms'] * 1e3:.4f} us "
            f"({r['bound_by']}; {r['work']}), {r['bound_ms'] / r['ms']:.3f} of the bound; "
            f"host {r['host_us']:.2f} us a kernel call, {r['plain_host_us']:.1f} us a "
            f"plain call [{card}]")

    descs_times = time_descs(dev)
    for r in descs_times:
        log(f"  descs {r['what']}: kernel {r['ms'] * 1e3:.2f} us, plain "
            f"{r['plain_ms'] * 1e3:.1f} us, bound {r['bound_ms'] * 1e3:.4f} us "
            f"({r['bound_by']}; {r['work']}), {r['bound_ms'] / r['ms']:.4f} of the bound; "
            f"redraws max {r['redraws_max']} sum {r['redraws_sum']}; host "
            f"{r['host_us']:.2f} us a kernel call, {r['plain_host_us']:.1f} us a plain call "
            f"[{card}]")

    from minigrid_tpu_torch.tools import bench

    venv = bench.make_venv(dev)
    rate = bench.measure(venv, MAIN_STEPS)
    log(f"  port {ENV_ID} B={NUM_ENVS} pooled {POOL_REFILL}/{REFILL_PERIOD}, actions "
        f"drawn every step: {rate['env_steps_per_sec']:.0f} env-steps/s, "
        f"{rate['us_per_step']:.1f} us/step over {MAIN_STEPS} steps, "
        f"fresh fraction {rate['fresh_frac']} [{card}]")
    # like with like: both engines read their actions from one [T, B] draw
    # made before the timer starts, and fold the same checksum every step
    pooled = bench.measure(venv, MAIN_STEPS, predrawn=True)
    fused_rate = bench.measure_fused(bench.make_fused(dev), MAIN_STEPS)
    fused_prof = bench.profile_fused(bench.make_fused(dev), 64)
    for name, r in (("pooled", pooled), ("fused", fused_rate)):
        log(f"  port {ENV_ID} B={NUM_ENVS} {name}, predrawn actions: "
            f"{r['env_steps_per_sec']:.0f} env-steps/s, {r['us_per_step']:.1f} us/step "
            f"over {MAIN_STEPS} steps, fresh fraction {r['fresh_frac']} [{card}]")
    log(f"  fused path under torch.profiler, 64 steps: "
        f"{fused_prof['launches_per_step']:.2f} launches/step, device busy "
        f"{fused_prof['device_busy_us_per_step']:.1f} us/step of "
        f"{fused_prof['wall_us_per_step']:.1f} us/step wall, idle share "
        f"{fused_prof['device_idle_share']:.3f} [{card}]")
    log(f"  total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": [{
        "name": "obs_gather",
        "route": "cuda",
        "source": "minigrid_tpu_torch/csrc/obs_gather.cu",
        "replaces": "minigrid_tpu/ops/obs_pallas.py:83",
        "launches": main["launches"]["obs_gather"],
        "max_abs_err": err,
        "ms": times["ms"],
        "plain_ms": times["plain_ms"],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": times["library_ms"],
    }, {
        "name": "fused_step",
        "route": "cuda",
        "source": "minigrid_tpu_torch/csrc/fused_step.cu",
        "replaces": "minigrid_tpu/ops/fused_step.py:75",
        "launches": fused_main["launches"]["fused_step"],
        "max_abs_err": fused_err,
        "ms": fused_times["ms"],
        "plain_ms": fused_times["plain_ms"],
        "bound_ms": fused_bound,
        "bound_by": fused_bound_by,
        "library_ms": fused_times["library_ms"],
    }, {
        "name": "threefry",
        "route": "cuda",
        "source": "minigrid_tpu_torch/csrc/threefry.cu",
        "replaces": None,
        "launches": goto_hashes["per_step"][0],
        "max_abs_err": threefry_err,
        "ms": threefry_times[-1]["ms"],
        "plain_ms": threefry_times[-1]["plain_ms"],
        "bound_ms": threefry_times[-1]["bound_ms"],
        "bound_by": threefry_times[-1]["bound_by"],
        "library_ms": None,
        "shapes": threefry_times,
    }, {
        "name": "distractors",
        "route": "cuda",
        "source": "minigrid_tpu_torch/csrc/distractors.cu",
        "replaces": None,
        "launches": goto_hashes["distractors_per_step"][0],
        "max_abs_err": distractors_err,
        "ms": distractors_times[0]["ms"],
        "plain_ms": distractors_times[0]["plain_ms"],
        "bound_ms": distractors_times[0]["bound_ms"],
        "bound_by": distractors_times[0]["bound_by"],
        "library_ms": None,
        "shapes": distractors_times,
    }, {
        "name": "descs",
        "route": "cuda",
        "source": "minigrid_tpu_torch/csrc/descs.cu",
        "replaces": None,
        "launches": boss_descs["per_step"][0][1],
        "max_abs_err": descs_err,
        "ms": descs_times[0]["ms"],
        "plain_ms": descs_times[0]["plain_ms"],
        "bound_ms": descs_times[0]["bound_ms"],
        "bound_by": descs_times[0]["bound_by"],
        "library_ms": None,
        "shapes": descs_times,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
