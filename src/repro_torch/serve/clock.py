"""TickClock — the daemon-cadence step counter, factored out of the engine.

``ServeEngine._maybe_tick`` advances the step counter by 1 per decode step
and by the CHUNK LENGTH per prefill chunk, and must fire one daemon tick
per migration-interval boundary the advance crosses — a chunk of length
``3 * interval`` owes exactly 3 ticks, and a chunk that lands exactly ON a
boundary owes the boundary's tick once (not zero, not twice).  The integer
arithmetic is easy to get off by one, so it lives here with its own tests
(tests/test_tick_clock.py) instead of inline in the engine.
"""
from __future__ import annotations


class TickClock:
    """Counts steps; reports how many interval boundaries each advance crossed.

    The boundary at step ``k * interval`` belongs to the advance that
    REACHES it: ``advance(n)`` returns ``floor((steps + n) / interval) -
    floor(steps / interval)``, so every boundary is counted exactly once
    across any partition of the step stream into advances.
    """

    def __init__(self, interval: int):
        if interval <= 0:
            raise ValueError(f"interval must be positive, got {interval}")
        self.interval = int(interval)
        self.steps = 0

    def advance(self, n: int = 1) -> int:
        """Advance by ``n`` steps; return the number of ticks now due."""
        if n < 0:
            raise ValueError(f"cannot advance by {n} steps")
        ticks = (self.steps + n) // self.interval - self.steps // self.interval
        self.steps += n
        return ticks
