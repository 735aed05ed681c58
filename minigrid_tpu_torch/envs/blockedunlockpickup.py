"""BlockedUnlockPickupEnv — a ball blocks the locked door.

Counterpart of ``minigrid_tpu/envs/blockedunlockpickup.py``: UnlockPickup
plus a ball of a random color directly left of the door.
"""

from __future__ import annotations

import numpy as np
import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid_ops as G
from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.core.roomgrid import type_triple
from minigrid_tpu_torch.core.sampling import rand_color
from minigrid_tpu_torch.core.state import EnvParams, EnvState, base_state, resolve_device
from minigrid_tpu_torch.envs.unlockpickup import UnlockPickupEnv, target_mission

_BALL = C.OBJECT_TO_IDX["ball"]


class BlockedUnlockPickupEnv(UnlockPickupEnv):
    name = "BlockedUnlockPickup"

    def __init__(self, max_steps: int | None = None, **kwargs):
        room_size = 6
        if max_steps is None:
            max_steps = 16 * room_size**2
        super().__init__(max_steps=max_steps, **kwargs)

    def generate(self, keys: torch.Tensor, params: EnvParams,
                 device=None) -> EnvState:
        keys = keys.to(resolve_device(device))
        n = keys.shape[0]
        k = rng.split(keys, 7).unbind(1)
        b = self.init_rooms(k[0], params)
        b, obj, _ = self.add_object(b, k[1], params, 1, 0, kind="box")
        b, door, door_pos = self.add_door(b, k[2], 0, 0, 0, locked=True)
        # the ball blocking the door
        ball = type_triple(_BALL, rand_color(k[3]), n, keys.device)
        b = dict(b)
        b["grid"] = G.put(b["grid"], door_pos[:, 0] - 1, door_pos[:, 1], ball)
        b, _, _ = self.add_object(b, k[4], params, 0, 0, kind="key",
                                  color=door[:, 1].to(torch.int32))
        b = self.place_agent_in_room(b, k[5], params, 0, 0)
        return base_state(b["grid"], b["agent_pos"], b["agent_dir"], rng=k[6],
                          mission=target_mission(obj),
                          extra=obj[:, :2].to(torch.int32))

    def mission_text(self, mission) -> str:
        return (f"pick up the {C.IDX_TO_COLOR[int(mission[0])]} "
                f"{C.IDX_TO_OBJECT[int(mission[1])]}")

    def mission_codes(self) -> np.ndarray:
        return np.asarray([(c, C.OBJECT_TO_IDX[t], 0, 0)
                           for c in C.COLOR_TO_IDX.values() for t in ("box", "key")],
                          dtype=np.int32)
