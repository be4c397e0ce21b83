"""The whole RL step's share of the card's float32 peak, in percent: the
counted operations of the window's env-steps (RHS calls and the policy's
convolutions, from shapes) over the window's seconds and the peak."""
from bench.count import peaks, work


def read(r):
    steps = r.counts.get("env_steps")
    if not steps or r.window_s <= 0:
        return None
    flop = work.flop_per_env_step(work.case(r.config)) * steps
    return 100.0 * flop / r.window_s / peaks.PEAK_FP32_PER_S
