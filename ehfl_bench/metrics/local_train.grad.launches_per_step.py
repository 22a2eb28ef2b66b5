"""local_train.grad.launches_per_step (count): kernels (copies and sets
excluded) whose launching host op started inside an
``ehfl.local_train.grad`` range, over the number of those ranges (the SGD
steps traced)."""
import bisect


def read(tr):
    steps = [(s, e) for name, s, e in tr.ranges if name == "ehfl.local_train.grad"]
    launches = sorted(launch for _, _, _, launch in tr.kernels if launch is not None)
    if not steps or not launches:
        return None
    count = sum(bisect.bisect_right(launches, e) - bisect.bisect_left(launches, s) for s, e in steps)
    return count / len(steps) if count else None
