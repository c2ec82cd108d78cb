"""Sets of runs of one cell, and the spread of each metric in each set: the
measurement a bound is set from.

    python3 -m benchmark.sets --workload <name> --seeds 1,2,3,4,5,6 [--sets 2]
        [--seconds 10] [--trace-seeds 7,8,9] [--out DIR]

runs the cell once a seed, set after set with the same seeds, each run a
process of its own and one at a time (one process a card), then once a
trace seed with --trace 1.  Every run's result line goes to DIR (and its
standard error beside it); the last line printed is a JSON summary: each
set's values and median for every metric, and its spreads, each as a share
of the median:

- `spread`: the distance between the first and the third quartile of
  `statistics.quantiles(values, n=4)`, over all the set's runs;
- `spread_tight`: the same with the run farthest from the median left out
  (where that narrows it), as a check of tightness reads a set;
- `range_tight`: the distance from the least to the largest value with
  that run left out, a wider reading of the same.

Per metric, `gate` gives the mean of the sets' `spread_tight` and of their
`range_tight` (a bound has to be at least twice the larger of the two) and
the widest `spread` (a bound over eight times it reads as too loose).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys


def spread(values) -> float:
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def farthest_out(values) -> list:
    """The values less the one farthest from their median, where that
    narrows them (five or more values)."""
    if len(values) < 5:
        return list(values)
    med = statistics.median(values)
    rest = list(values)
    rest.remove(max(values, key=lambda v: abs(v - med)))
    return rest if spread(rest) <= spread(values) else list(values)


def spreads(values) -> dict:
    med, rest = statistics.median(values), farthest_out(values)
    return dict(spread=spread(values), spread_tight=spread(rest),
                range_tight=(max(rest) - min(rest)) / med)


def gate(sets: list) -> dict:
    """Per metric over the sets' spreads: the means that a check of
    tightness reads, the widest that one of looseness reads, and the bounds
    between them."""
    out = {}
    for m in sets[0]:
        ss = [s[m] for s in sets if s.get(m, {}).get("spread") is not None]
        if not ss:
            continue
        tight = statistics.mean(s["spread_tight"] for s in ss)
        rng = statistics.mean(s["range_tight"] for s in ss)
        widest = max(s["spread"] for s in ss)
        out[m] = dict(mean_spread_tight=tight, mean_range_tight=rng, widest_spread=widest,
                      bound_at_least=2 * max(tight, rng), bound_at_most=8 * widest)
    return out


def run_once(workload: str, seed: int, seconds: float, trace: int, out_dir: str, tag: str):
    base = os.path.join(out_dir, f"{workload}.{seed}.{trace}.{tag}")
    with open(base + ".err", "w") as err:
        p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", workload,
                            "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)],
                           stdout=subprocess.PIPE, stderr=err, text=True)
    with open(base + ".out", "w") as f:
        f.write(p.stdout)
    lines = p.stdout.strip().splitlines()
    if p.returncode != 0 or not lines:
        return dict(seed=seed, rc=p.returncode, result=None)
    return dict(seed=seed, rc=0, result=json.loads(lines[-1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=10)
    ap.add_argument("--trace-seeds", default="")
    ap.add_argument("--out", default=os.path.join("benchmark", "_cache", "sets"))
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    seeds = [int(s) for s in args.seeds.split(",")]
    sets, ok = [], True
    for k in range(args.sets):
        runs = [run_once(args.workload, s, args.seconds, 0, args.out, f"set{k}") for s in seeds]
        for r in runs:
            res = r["result"]
            ok &= res is not None and res["correct"]
            print(json.dumps(dict(set=k, seed=r["seed"], rc=r["rc"],
                                  correct=res and res["correct"],
                                  metrics={m: v["value"] for m, v in (res or {}).get(
                                      "metrics", {}).items()})), flush=True)
        sets.append(runs)
    traced = []
    for s in [int(x) for x in args.trace_seeds.split(",") if x]:
        r = run_once(args.workload, s, args.seconds, 1, args.out, "trace")
        res = r["result"]
        ok &= res is not None and res["correct"]
        traced.append(dict(seed=s, rc=r["rc"], correct=res and res["correct"],
                           metrics={m: v["value"] for m, v in (res or {}).get("metrics", {}).items()},
                           device=(res or {}).get("device")))
        print(json.dumps(traced[-1]), flush=True)
    summary = dict(workload=args.workload, all_correct=ok, sets=[], traced=traced)
    for runs in sets:
        vals: dict = {}
        for r in runs:
            for m, v in ((r["result"] or {}).get("metrics") or {}).items():
                vals.setdefault(m, []).append(v["value"])
        summary["sets"].append({m: dict(values=v, median=statistics.median(v),
                                        **(spreads(v) if len(v) >= 2 else dict(spread=None)))
                                for m, v in vals.items()})
    if summary["sets"]:
        summary["gate"] = gate(summary["sets"])
    print(json.dumps(summary), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
