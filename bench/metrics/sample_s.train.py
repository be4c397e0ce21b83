"""Seconds a PPO iteration spends sampling: `Runner.run_iteration`'s own
`t_sample_s` (host clock after a device sync), the mean over the window."""


def read(r):
    spans = r.spans.get("t_sample_s") or []
    return sum(spans) / len(spans) if spans else None
