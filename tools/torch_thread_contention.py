"""How torch's intra-op thread count fares on a CPU shared with other busy
processes, as the test suite's `pytest -n 6` shares eight cores.

    PYTHONPATH=src python tools/torch_thread_contention.py [--busy 5]
        [--threads 8 1] [--seconds 150]

Times `python -m repro_torch.launch.train --reduced --device cpu --batch 2
--seq 24 --steps 3` (hymba-1.5b reduced, the workload of
`tests/test_torch_lm_train.py::test_train_cli_resumes_where_it_stopped`)
once per thread count on an idle machine, then again while `--busy`
processes each run small torch operations on torch's default thread
count (as the suite's other workers do).  Prints one line per run: the
thread count, the load, the seconds.  Runs on the CPU only.
"""
from __future__ import annotations

import argparse
import multiprocessing as mp
import tempfile
import time


def _busy(seconds: float) -> None:
    import torch

    a = torch.randn(64, 64)
    t0 = time.time()
    while time.time() - t0 < seconds:
        for _ in range(200):
            a = torch.tanh(a @ a * 0.01) + torch.roll(a, 1, 0)


def _train(threads: int, out) -> None:
    import torch

    torch.set_num_threads(threads)
    from repro_torch.launch import train

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        train.main(["--reduced", "--device", "cpu", "--batch", "2", "--seq",
                    "24", "--steps", "3", "--checkpoint-dir", d])
    out.put(time.perf_counter() - t0)


def _timed(threads: int) -> float:
    q = mp.get_context("spawn").Queue()
    p = mp.get_context("spawn").Process(target=_train, args=(threads, q))
    p.start()
    secs = q.get()
    p.join()
    return secs


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--busy", type=int, default=5)
    ap.add_argument("--threads", type=int, nargs="+", default=[8, 1])
    ap.add_argument("--seconds", type=float, default=150.0)
    args = ap.parse_args()
    for n in args.threads:
        print(f"threads {n}, idle: {_timed(n):.3f} s", flush=True)
    ctx = mp.get_context("spawn")
    busy = [ctx.Process(target=_busy, args=(args.seconds,))
            for _ in range(args.busy)]
    for p in busy:
        p.start()
    try:
        for n in args.threads:
            print(f"threads {n}, beside {args.busy} busy processes: "
                  f"{_timed(n):.3f} s", flush=True)
    finally:
        for p in busy:
            p.terminate()
            p.join()


if __name__ == "__main__":
    main()
