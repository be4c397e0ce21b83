"""The whole PPO iteration's share of the card's float32 peak, in
percent: the counted operations of the window's iterations (the sampling
as `mfu.rollout` counts it, and each epoch's forward and backward over the
whole batch) over the window's seconds and the peak."""
from bench.count import peaks, work


def read(r):
    n = r.counts.get("iterations")
    if not n or r.window_s <= 0:
        return None
    flop = n * work.flop_per_iteration(work.case(r.config),
                                       r.traffic["n_envs"],
                                       r.traffic["epochs"])
    return 100.0 * flop / r.window_s / peaks.PEAK_FP32_PER_S
