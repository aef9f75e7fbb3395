"""The port's twins of the JAX package's tools/ scripts."""

import torch


def time_ms(fn, iters: int) -> float:
    """Median of `iters` CUDA-event-timed calls after two warm-ups."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]
