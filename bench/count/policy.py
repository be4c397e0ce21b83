"""Floating-point operations of the policy's convolutions (actor and
critic trunks, paper Table 2), from shapes alone, counted as
`torch.utils.flop_counter` counts a convolution: 2 per multiply-add, bias
and activations not counted."""
from __future__ import annotations


def conv_plan(n: int) -> list[tuple[int, int, int]]:
    """[(kernel, filters, padding)] of one trunk over n nodes a direction:
    a padded k3 layer of 8 filters, unpadded k3 layers (the last of 4
    filters) down to 2 or 1 nodes, then a k2 layer of 1 filter (an odd n
    ends on the k3 layer, of 1 filter)."""
    plan = [(3, 8, 1)]
    size = n
    n_valid = max((size - 1) // 2, 0)
    for i in range(n_valid):
        plan.append((3, 4 if i == n_valid - 1 else 8, 0))
        size -= 2
    if size == 2:
        plan.append((2, 1, 0))
    else:
        k, _, pad = plan.pop()
        plan.append((k, 1, pad))
    return plan


def _layers(n: int, channels: int) -> list[int]:
    """Forward FLOP of each layer of one trunk for one element."""
    out, size, c_in = [], n, channels
    for k, f, pad in conv_plan(n):
        size = size + 2 * pad - k + 1
        out.append(2 * size**3 * f * c_in * k**3)
        c_in = f
    return out


def forward(n: int, channels: int, elements: int) -> int:
    """One observation through both trunks."""
    return 2 * elements * sum(_layers(n, channels))


def forward_backward(n: int, channels: int, elements: int) -> int:
    """One observation through both trunks, forward and backward: the
    weight gradient of every layer and the input gradient of every layer
    but the first (the observation needs none), each the forward's FLOP."""
    per = _layers(n, channels)
    return 2 * elements * (2 * sum(per) + sum(per[1:]))
