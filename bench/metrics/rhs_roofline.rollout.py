"""The fused RHS's share of its roofline: the least time one call of the
fleet's batch can take on the card (its operations at the float32 peak,
or its bytes at the HBM bandwidth, the larger) over its mean device time
per call in the traced episode, in percent."""
from bench.count import rhs, work


def read(r):
    if r.trace is None:
        return None
    per_call = r.trace.mean_launch_s(*work.RHS_KERNELS)
    if not per_call:
        return None
    c = work.case(r.config)
    k = c.n_elem
    return 100.0 * rhs.bound_s(r.traffic["n_envs"], k, k, k, c.n) / per_call
