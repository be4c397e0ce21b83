"""rwkv6-1.6b's gradient at its init, leaf by leaf, along the kernel path,
the plain path and their neighbours, on the card.

    python tools/rwkv6_bf16_gradient.py [--out PATH.json]

One loss-and-gradient pass (`models.lm.lm_loss` and autograd, as
`api.train_step` takes them) of the full rwkv6-1.6b (24 layers, float32
masters drawn from seed 0) on the `TokenStream`'s first 2 x 1,024-token
batch, along these paths:

  float32: the plain path (`scan_impl="chunked"`), the kernel path, and
           the plain path with the scan's o one float32 ulp off at random
           elements (as many as the kernel's o differs in);
  bf16:    the kernel's plain version (`linear_scan_chunked` with o cast
           to bf16, as the wrapper runs it on a CPU tensor), the kernel
           path (what `launch.train --arch rwkv6-1.6b` runs), the plain
           version at chunk 32, the plain version with o one bf16 ulp off
           at random elements (two draws), and `scan_impl="chunked"`
           (o left in float32).

For each: the loss, the gradient norm, the norm of each kind of leaf
(summed over the layers; u_bonus, the decay and mix leaves first) and each
kind's distance from the float32 plain path's gradient and from the bf16
plain version's, as a fraction of that one's norm.  For the kernel paths:
the share of o's elements that the kernel rounds to another value than
its plain version, and by how many ulps at most.  Prints one line per
path and writes everything to `--out`.  Needs the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# frexp's mantissa lies in [0.5, 1): an ulp is 2^(exponent - these bits)
MANTISSA_BITS = {torch.bfloat16: 8, torch.float32: 24}
FIRST = ("u_bonus", "decay_base", "decay_lora_a.w", "decay_lora_b.w",
         "mix_base", "mix_lora_a.w", "mix_lora_b")


def kind(name: str) -> str:
    """A parameter's name without its layer: "layers.3.b0.mixer.u_bonus"
    -> "b0.mixer.u_bonus"."""
    parts = name.split(".")
    return ".".join(parts[2:]) if parts[0] == "layers" else name


def kind_order(kinds) -> list:
    def key(k):
        hits = [i for i, f in enumerate(FIRST) if k.endswith("mixer." + f)]
        return (hits[0] if hits else len(FIRST), k)
    return sorted(set(kinds), key=key)


def ulp_nudged(o: torch.Tensor, share: float, gen: torch.Generator
               ) -> torch.Tensor:
    """o with a random `share` of its non-zero elements moved one ulp away
    from zero (the next representable magnitude of its dtype)."""
    bits = {torch.bfloat16: torch.int16, torch.float32: torch.int32}[o.dtype]
    pick = (torch.rand(o.shape, generator=gen, device=o.device) < share) \
        & (o != 0)
    return (o.view(bits) + pick.to(bits)).view(o.dtype)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(
        ROOT, "chiprun_out", "rwkv6_bf16_gradient.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("rwkv6_bf16_gradient: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import configs
    from repro_torch.data import TokenStream
    from repro_torch.kernels import linear_scan, ops
    from repro_torch.models import api, lm

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get("rwkv6-1.6b")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    batch = TokenStream(cfg, 2, 1024, seed=0).next()
    params = api.init(cfg, seed=0)
    named = dict(params.named_parameters())
    scan = ops.gated_linear_scan

    def plain(q, k, v, w, u=None, s0=None, *, decay_before_read=False,
              impl="kernel", chunk=64):
        """The kernel's plain version, o in q's dtype."""
        o, s = linear_scan.linear_scan_chunked(
            q, k, v, w, u, s0, decay_before_read=decay_before_read,
            chunk=chunk)
        return o.to(q.dtype), s

    def at_chunk(chunk_to: int):
        def call(q, k, v, w, u=None, s0=None, *, chunk=64, **kw):
            return plain(q, k, v, w, u, s0, chunk=chunk_to, **kw)
        return call

    def nudged(share: float, seed: int):
        """The plain version with o one ulp off at the same random elements
        in every call (the remat recompute draws what the forward drew)."""
        def call(*a, **kw):
            o, s = plain(*a, **kw)
            gen = torch.Generator(device=o.device).manual_seed(seed)
            # the step to the neighbour is exact; the gradient passes as is
            return o + (ulp_nudged(o.detach(), share, gen) - o.detach()), s
        return call

    def compared(stats: dict):
        """The kernel, with each call's o held against the plain version's
        on the same inputs: the share of elements that differ, the most
        ulps apart."""
        def call(q, k, v, w, u=None, s0=None, **kw):
            o, s = scan(q, k, v, w, u, s0, **kw)
            with torch.no_grad():
                po, _ = plain(*(x.detach() if x is not None else None
                                for x in (q, k, v, w, u, s0)), **kw)
                # |o - plain| in ulps of the plain value's binade
                _, exp = torch.frexp(po.float())
                ulp = torch.ldexp(torch.ones_like(exp, dtype=torch.float32),
                                  exp - MANTISSA_BITS[o.dtype])
                ulps = (o.detach().float() - po.float()).abs() / ulp
                stats["differ"] = stats.get("differ", 0) + int(
                    (o.detach() != po).sum())
                stats["elements"] = stats.get("elements", 0) + o.numel()
                stats["max_ulps"] = max(stats.get("max_ulps", 0.0),
                                        float(ulps.max()))
            return o, s
        return call

    refs, refs_sq, out = {}, {}, {"card": card, "paths": {}}

    def run(label: str, c, call, keep: str | None = None) -> None:
        gc.collect()
        torch.cuda.empty_cache()
        ops.gated_linear_scan = call or scan
        try:
            params.requires_grad_(True)
            loss, _ = lm.lm_loss(params, c, batch)
            grads = torch.autograd.grad(loss, list(named.values()))
        finally:
            ops.gated_linear_scan = scan
        g = dict(zip(named, grads))
        sq = {}
        for n, x in g.items():
            sq[kind(n)] = sq.get(kind(n), 0.0) + float(
                torch.sum(torch.square(x.double())))
        rec = {"loss": float(loss.detach()),
               "grad_norm": math.sqrt(sum(sq.values())),
               "norm_by_kind": {k: math.sqrt(v) for k, v in sq.items()}}
        for ref_label, ref in refs.items():
            d = {}
            for n, x in g.items():
                d[kind(n)] = d.get(kind(n), 0.0) + float(
                    torch.sum(torch.square((x - ref[n]).double())))
            rec[f"distance_from {ref_label}"] = {
                k: math.sqrt(v) / max(math.sqrt(refs_sq[ref_label][k]),
                                      1e-30) for k, v in d.items()}
            rec[f"distance_from {ref_label}"]["all"] = math.sqrt(
                sum(d.values())) / math.sqrt(sum(refs_sq[ref_label]
                                                 .values()))
        if keep:
            refs[keep] = {n: x.detach() for n, x in g.items()}
            refs_sq[keep] = sq
        out["paths"][label] = rec
        u = rec["norm_by_kind"]["b0.mixer.u_bonus"]
        dist = "; ".join(
            f"from {r}: all {rec[f'distance_from {r}']['all']:.3e}, u_bonus "
            f"{rec[f'distance_from {r}']['b0.mixer.u_bonus']:.3e}"
            for r in refs if f"distance_from {r}" in rec)
        print(f"rwkv6-1.6b loss and gradient, {label} ({card}): loss "
              f"{rec['loss']:.6f}, grad_norm {rec['grad_norm']:.3f}, "
              f"u_bonus {u:.3f} ({u ** 2 / rec['grad_norm'] ** 2:.3f} of "
              f"the squared norm); {dist}", flush=True)

    stats32, stats16 = {}, {}
    plain32 = dataclasses.replace(cfg32, scan_impl="chunked")
    run("float32 plain", plain32, None, keep="float32 plain")
    run("float32 kernel", cfg32, compared(stats32))
    share32 = stats32["differ"] / stats32["elements"]
    run("float32 plain, o one ulp off", plain32, nudged(share32, 1))
    run("bf16 plain version", cfg, plain, keep="bf16 plain version")
    run("bf16 kernel (the main path)", cfg, compared(stats16))
    share16 = stats16["differ"] / stats16["elements"]
    run("bf16 plain version, chunk 32", cfg, at_chunk(32))
    for seed in (1, 2):
        run(f"bf16 plain version, o one ulp off (draw {seed})", cfg,
            nudged(share16, seed))
    run("bf16 scan_impl=chunked (o float32)",
        dataclasses.replace(cfg, scan_impl="chunked"), None)
    out["kernel_vs_plain_o"] = {"float32": stats32, "bf16": stats16}
    for dt, st in out["kernel_vs_plain_o"].items():
        print(f"{dt} kernel path's o against its plain version on the same "
              f"inputs, over {st['elements']} elements of the forward and "
              f"recompute calls: {st['differ'] / st['elements']:.4%} differ, "
              f"at most {st['max_ulps']} ulps")
    order = kind_order(out["paths"]["bf16 plain version"]["norm_by_kind"])
    out["kinds"] = order
    print("gradient norm by kind of leaf (summed over layers):")
    print("  " + " | ".join(["kind"] + list(out["paths"])))
    for k in order:
        print("  " + " | ".join([k] + [f"{r['norm_by_kind'][k]:.4g}"
                                       for r in out["paths"].values()]))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
