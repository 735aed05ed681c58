"""MissionSpace: the reference's string mission space, on the host.

Counterpart of ``minigrid_tpu/core/mission.py``.  In the batch engine a
mission travels as a packed int code (``Env.mission_codes``); this class is
the string surface for users and for gymnasium observation spaces.  It samples
mission strings from a template function over ordered placeholder lists, and
``contains`` rebuilds the placeholders of a string.  gymnasium is optional:
without it the class stands alone with a numpy generator.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np

try:
    from gymnasium import spaces as _gym_spaces

    _BASE = _gym_spaces.Space
except Exception:  # gymnasium is optional
    _BASE = object


def check_if_no_duplicate(duplicate_list: list) -> bool:
    return len(set(duplicate_list)) == len(duplicate_list)


class MissionSpace(_BASE):
    """A space of mission strings."""

    def __init__(
        self,
        mission_func: Callable[..., str],
        ordered_placeholders: list[list[str]] | None = None,
        seed=None,
    ):
        if ordered_placeholders is not None:
            if len(ordered_placeholders) != mission_func.__code__.co_argcount:
                raise ValueError(
                    f"The number of placeholders {len(ordered_placeholders)} is "
                    "different from the number of parameters in the mission "
                    f"function {mission_func.__code__.co_argcount}.")
            for placeholder_list in ordered_placeholders:
                if not check_if_no_duplicate(placeholder_list):
                    raise ValueError("Make sure that the placeholders don't "
                                     "have any duplicate values.")
        elif mission_func.__code__.co_argcount != 0:
            raise ValueError("a mission function without placeholders takes "
                             "no arguments")

        self.ordered_placeholders = ordered_placeholders
        self.mission_func = mission_func

        if _BASE is not object:
            super().__init__(dtype=str, seed=seed)
        else:
            self._np_random = np.random.default_rng(seed)

        if not isinstance(self.sample(), str):
            raise TypeError("the mission function must return a string")

    @property
    def np_random(self):
        if _BASE is not object:
            return super().np_random
        return self._np_random

    def sample(self) -> str:
        """A random mission string."""
        if self.ordered_placeholders is not None:
            placeholders = []
            for rand_var_list in self.ordered_placeholders:
                idx = self.np_random.integers(0, len(rand_var_list))
                placeholders.append(rand_var_list[idx])
            return self.mission_func(*placeholders)
        return self.mission_func()

    def contains(self, x: Any) -> bool:
        """Whether ``x`` is a mission of this space: the placeholders found
        in it, longest first where two overlap, must rebuild it."""
        if self.ordered_placeholders is None:
            return bool(self.mission_func() == x)

        # every placeholder occurrence in x, with its span
        occurrences: list[tuple[int, int, str]] = []
        seen = set()
        for placeholder_list in self.ordered_placeholders:
            for placeholder in placeholder_list:
                if placeholder in x and placeholder not in seen:
                    seen.add(placeholder)
                    start = 0
                    while True:
                        i = x.find(placeholder, start)
                        if i < 0:
                            break
                        occurrences.append((i, i + len(placeholder) - 1, placeholder))
                        start = i + 1
        occurrences.sort()

        # drop the shorter of any overlapping pair
        remove_ids: list[int] = []
        for i, p1 in enumerate(occurrences):
            for j, p2 in enumerate(occurrences[i + 1:]):
                if max(p1[0], p2[0]) < min(p1[1], p2[1]):
                    if min(p1[2], p2[2], key=len) == p1[2]:
                        remove_ids.append(i)
                    else:
                        remove_ids.append(i + j + 1)
        final = [p[2] for k, p in enumerate(occurrences) if k not in remove_ids]

        for placeholder_list, candidate in zip(self.ordered_placeholders, final):
            if candidate not in placeholder_list:
                return False
        try:
            reconstructed = self.mission_func(*final)
        except Exception:
            return False
        return bool(reconstructed == x)

    def __repr__(self) -> str:
        return f"MissionSpace({self.mission_func}, {self.ordered_placeholders})"

    def __eq__(self, other) -> bool:
        """Same placeholders (as sets) and the same template."""
        if not isinstance(other, MissionSpace):
            return False
        if self.ordered_placeholders is not None:
            if other.ordered_placeholders is None:
                return False
            if len(self.ordered_placeholders) == len(other.ordered_placeholders) and all(
                set(i) == set(j)
                for i, j in zip(self.ordered_placeholders, other.ordered_placeholders)
            ):
                test = [""] * len(self.ordered_placeholders)
                return self.mission_func(*test) == other.mission_func(*test)
            return False
        if other.ordered_placeholders is None:
            return self.mission_func() == other.mission_func()
        return False


class BabyAIMissionSpace(MissionSpace):
    """Mission space of grammar-made instructions: the language is a
    recursive grammar, not a template product, so ``contains`` takes every
    string and ``sample`` gives one representative instruction."""

    def __init__(self, mission_func=None):
        if mission_func is None:
            mission_func = _go_to_the_red_ball
        super().__init__(mission_func=mission_func)

    def contains(self, x) -> bool:
        return isinstance(x, str)


def _go_to_the_red_ball() -> str:
    return "go to the red ball"
