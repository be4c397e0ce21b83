"""What the benchmark sees of the env the program drives: its `step`.

`StepRecorder` stands where the orchestrator keeps its env and forwards
everything to it.  Around each step it stamps the device's stream (a CUDA
event, no sync) so that the interval between consecutive step completions
can be read after the window, and it keeps copies of the state rows that a
sample plan names, before and after the step, for the comparison with the
reference.  A copy is one small device-to-device copy; nothing waits for
the device."""
from __future__ import annotations

import time

import torch


class Stamps:
    """Completion stamps on a device's stream: CUDA events on a card (read
    after the window), the host clock elsewhere."""

    def __init__(self, device: torch.device, reserve: int = 4096):
        self.cuda = device.type == "cuda"
        self._pool = [self._new() for _ in range(reserve)] if self.cuda else []
        self._used: list = []

    def _new(self):
        return torch.cuda.Event(enable_timing=True) if self.cuda else None

    def stamp(self) -> None:
        if not self.cuda:
            self._used.append(time.perf_counter())
            return
        evt = self._pool.pop() if self._pool else self._new()
        evt.record()
        self._used.append(evt)

    def intervals_ms(self) -> list[float]:
        """Milliseconds between consecutive stamps (after a sync)."""
        if not self.cuda:
            return [(b - a) * 1e3 for a, b in zip(self._used, self._used[1:])]
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in zip(self._used, self._used[1:])]


class StepRecorder:
    """An env seen through its `step`; every other attribute is the env's."""

    def __init__(self, env):
        self.env = env
        self.stamps: Stamps | None = None
        self.plan: dict[int, tuple[int, ...]] = {}
        self.kept: dict[tuple[int, int], torch.Tensor] = {}
        self.t = 0

    def __getattr__(self, name):
        return getattr(self.env, name)

    def begin(self, plan: dict[int, tuple[int, ...]]) -> None:
        """A new episode: keep the rows `plan[t]` of the state before and
        after step t."""
        self.plan, self.kept, self.t = plan, {}, 0

    def step(self, state, action):
        rows = self.plan.get(self.t, ())
        for r in rows:
            self.kept[(r, self.t)] = state.u[r].clone()
        res = self.env.step(state, action)
        for r in rows:
            self.kept[(r, self.t + 1)] = res.state.u[r].clone()
        if self.stamps is not None:
            self.stamps.stamp()
        self.t += 1
        return res
