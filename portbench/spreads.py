"""Spreads of a cell's end-to-end metrics over sets of runs, and the bound
each suggests: the wider of the sets' quartile spreads (Q3 - Q1 over the
median, by `statistics.quantiles(n=4)`), times five, at least 1%.

    python3 portbench/spreads.py set1.jsonl set2.jsonl

Each file holds one run's result line per line (the last line of
`run.py`'s standard output), all of one cell and one set.
"""

import json
import statistics
import sys


def spread(values) -> float:
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def main(paths) -> int:
    sets = []
    for path in paths:
        with open(path) as f:
            sets.append([json.loads(line) for line in f if line.strip()])
    names = sorted({k for runs in sets for r in runs for k in r["metrics"]})
    for name in names:
        per_set = [[r["metrics"][name]["value"] for r in runs
                    if name in r["metrics"]] for runs in sets]
        widest = max(spread(v) for v in per_set)
        medians = [statistics.median(v) for v in per_set]
        print(json.dumps({"metric": name, "medians": medians,
                          "spreads": [spread(v) for v in per_set],
                          "bound": max(0.01, 5 * widest)}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
