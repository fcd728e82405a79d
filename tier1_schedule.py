"""How the tier-1 test run (pytest-xdist, `-n 6 --dist load`) places its
tests on workers, and whether it can end inside its time limit.

The JAX package's `tests/test_protocol.py::test_random_subset` kills its
worker (a segfault in XLA's CPU compile) about 20 minutes after it starts.
xdist then replaces the worker and only then runs the tests that the load
scheduler had queued behind it on that worker. When such tests exist, the
run cannot end inside the limit; when none do, it ends right after the
crash. Which tests land behind it depends on the number of tests
collected, since the scheduler's batch sizes follow the pending count.

Record the run's timeline with this module as a pytest plugin (every
worker appends its collection order and a line per test start and end):

    TIER1_SCHEDULE_LOG=build/tier1.log TIER1_SCHEDULE_T0=$(date +%s.%N) \\
      PYTHONPATH=. python -m pytest tests/ ... -n 6 --dist load -p tier1_schedule

Replay it through a copy of xdist's LoadScheduling (pytest-xdist 3.8)
with 0 to K extra tests appended to the collection, under random
duration noise and worker start orders:

    python3 tier1_schedule.py build/tier1.log --add 0-15

For each collection size it prints the JAX-package tests still queued on
the crashing test's worker when it dies (with the share of trials), the
seconds of all tests queued there and the crashing test's start (medians),
and the share of trials in which the run either ends before the limit or
the crash comes after it (when the limit cuts the run after the crash, its
count of passes is lost).
"""

import argparse
import heapq
import os
import random
import time

CRASHER = "tests/test_protocol.py::test_random_subset"
LIMIT = 1470.0

_LOG = os.environ.get("TIER1_SCHEDULE_LOG")
_T0 = float(os.environ.get("TIER1_SCHEDULE_T0", "0") or 0)
_WORKER = os.environ.get("PYTEST_XDIST_WORKER")


def _note(what, nodeid):
    if _LOG and _WORKER:
        with open(_LOG, "a") as f:
            f.write(f"{time.time() - _T0:.1f} {_WORKER} {what} {nodeid}\n")


def pytest_collection_finish(session):
    _note("collected", len(session.items))
    if _WORKER == "gw0":
        for item in session.items:
            _note("item", item.nodeid)


def pytest_runtest_logstart(nodeid, location):
    _note("start", nodeid)


def pytest_runtest_logfinish(nodeid, location):
    _note("end", nodeid)


def read_log(path):
    """(collection order, durations, first start, crash duration)."""
    items, starts, dur, up = [], {}, {}, []
    for line in open(path):
        t, worker, what, arg = line.split(None, 3)
        t, arg = float(t), arg.strip()
        if what == "item":
            items.append(arg)
        elif what == "collected":
            up.append(t)
        elif what == "start":
            starts[arg] = t
        elif what == "end":
            dur[arg] = t - starts[arg]
    first = min(starts.values())
    crash = None
    if CRASHER in starts and CRASHER not in dur:
        later = [t for t in up if t > starts[CRASHER]]
        if later:                       # the replacement worker's collection
            crash = later[0] - min(up) - starts[CRASHER]
    return items, dur, first, crash


def simulate(items, dur, t0, crash, order, restart):
    """Replay LoadScheduling: returns (end, crasher start, the tests still
    queued on the crasher's worker when it dies)."""
    pending = list(range(len(items)))
    queue = {n: [] for n in order}
    shut, behind, starts, events, seq = set(), [], {}, [], [0]

    def send(n, k):
        batch = pending[:k]
        del pending[:k]
        queue[n].extend(batch)

    def run_head(n, t):
        if queue[n]:
            i = queue[n][0]
            starts[items[i]] = t
            d = crash if items[i] == CRASHER else dur[items[i]]
            seq[0] += 1
            heapq.heappush(events, (t + d, seq[0], n, i))

    def check(n, duration, t):
        if n in shut:
            return
        if not pending:
            shut.add(n)
            return
        per = len(pending) // len(queue)
        low, high = max(2, per // 4), max(2, per // 2)
        if len(queue[n]) < low:
            if duration >= 0.1 and len(queue[n]) >= 2:
                return
            idle = not queue[n]
            send(n, high - len(queue[n]))
            if idle and duration == 0:
                run_head(n, t)

    chunk = max(len(items) // len(order) // 4, 2)
    for n in order:
        send(n, chunk)
    for n in order:
        run_head(n, t0)
    end, new = t0, max(order) + 1
    while events:
        t, _, n, i = heapq.heappop(events)
        end = max(end, t)
        if i < 0:                               # a replacement is ready
            queue[n] = []
            for m in list(queue):
                check(m, 0, t)
            continue
        queue[n].remove(i)
        if items[i] == CRASHER:
            behind[:] = [items[j] for j in queue[n]]
            pending.extend(queue.pop(n))
            seq[0] += 1
            heapq.heappush(events, (t + restart, seq[0], new, -1))
            new += 1
            continue
        check(n, dur[items[i]], t)
        run_head(n, t)
    return end, starts[CRASHER], behind


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("log")
    ap.add_argument("--add", default="0-0", help="extra tests, A-B")
    ap.add_argument("--trials", type=int, default=200)
    ap.add_argument("--noise", type=float, default=0.2,
                    help="durations scaled by 1 +- this, uniform")
    ap.add_argument("--missing", type=float, default=300.0,
                    help="seconds for tests the log has no end for")
    ap.add_argument("--crash", type=float, default=None,
                    help="seconds from the crasher's start to its crash")
    args = ap.parse_args()
    items, dur, first, crash = read_log(args.log)
    crash = args.crash or crash
    if crash is None:
        raise SystemExit("no crash in the log: give --crash SECONDS")
    tail = [i for i in items if "test_torch_" in i] or items
    lo, hi = (int(x) for x in args.add.split("-"))
    print(f"log: {len(items)} tests, first start {first:.1f} s, crash "
          f"{crash:.1f} s after the crasher's start")
    for k in range(lo, hi + 1):
        extra = [f"{tail[j % len(tail)]}#{j}" for j in range(k)]
        base = dict(dur)
        for j, e in enumerate(extra):
            base[e] = dur.get(tail[j % len(tail)], args.missing)
        its = items + extra
        good, seen, at, queued = 0, {}, [], []
        for trial in range(args.trials):
            rng = random.Random(trial)
            d = {i: base.get(i, args.missing) * rng.uniform(
                1 - args.noise, 1 + args.noise) for i in its}
            order = list(range(6))
            rng.shuffle(order)
            c = crash * rng.uniform(1 - args.noise / 2, 1 + args.noise / 2)
            end, start, behind = simulate(its, d, first, c, order, first)
            good += start + c > LIMIT or end < LIMIT
            key = ", ".join(b.split("::")[-1] for b in behind
                            if "test_torch_" not in b) or "-"
            seen[key] = seen.get(key, 0) + 1
            at.append(start)
            queued.append(sum(d[b] for b in behind))
        at.sort()
        queued.sort()
        print(f"{len(its):4d} tests (+{k}): JAX tests behind the crasher "
              f"{sorted(seen.items())}, seconds queued behind it "
              f"{queued[len(queued) // 2]:.1f}, its start "
              f"{at[len(at) // 2]:.1f} s, ends or crashes after the limit "
              f"{good / args.trials:.2f}")


if __name__ == "__main__":
    main()
