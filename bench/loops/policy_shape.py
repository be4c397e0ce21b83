"""The traffic's policy: the program's own seeded initial weights, then
shaped as the traffic's `policy` entry says, so that the actions stay in a
band of C_s where every RL interval stays finite (the reference shapes its
own weights the same way, `bench.reference.policy.init_params`)."""
from __future__ import annotations

import math

import torch


def shape(policy, spec: dict) -> None:
    """Scale the actor's last weights by `actor_out_scale`, set its last
    bias so that a zero input gives the mean action `mean_cs`, and set
    `log_std`, in place."""
    last = policy.actor[-1]
    p = (spec["mean_cs"] - policy.cfg.act_low) / (policy.cfg.cs_max
                                                  - policy.cfg.act_low)
    with torch.no_grad():
        last.weight.mul_(spec["actor_out_scale"])
        last.bias.fill_(math.log(p / (1.0 - p)))
        policy.log_std.fill_(float(spec["log_std"]))
