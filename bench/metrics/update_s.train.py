"""Seconds a PPO iteration spends in its update (the epochs):
`Runner.run_iteration`'s own `t_update_s`, the mean over the window."""


def read(r):
    spans = r.spans.get("t_update_s") or []
    return sum(spans) / len(spans) if spans else None
