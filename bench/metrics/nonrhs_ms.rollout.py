"""Device milliseconds per RL step in ops other than the fused RHS (RK
updates, observation, reward, spectra, policy), in the traced episode:
the device's busy time less the RHS calls the step needs at the traced
mean per call."""
from bench.count import work


def read(r):
    t = r.trace
    steps = r.trace_counts.get("rl_steps")
    if t is None or not steps or t.busy_s <= 0:
        return None
    per_call = t.mean_launch_s(*work.RHS_KERNELS)
    if per_call is None:
        return None
    rhs_s = per_call * work.rhs_calls_per_step(work.case(r.config)) * steps
    return (t.busy_s - rhs_s) / steps * 1e3
