"""Write `BENCHMARK.json` from what the harness finds: the accepted cells
(those `BENCHMARK.json` lists, in its order, then those named by `--add`),
their configurations, and every metric they name, each per-layer metric
with the cells that report it.

    python3 portbench/make_benchmark.py [--add <cell> ...] [--check]

`--check` compares with the file on disk instead of writing it.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

COMMAND = ["python3", "portbench/run.py"]
PATHS = ["portbench"]
RUN_SECONDS = 10


def cells(added=()):
    """(name, workload) of the accepted cells: `BENCHMARK.json`'s, then
    `added`."""
    path = ROOT / "BENCHMARK.json"
    listed = ([w["name"] for w in json.loads(path.read_text())["workloads"]]
              if path.is_file() else [])
    names = listed + [n for n in added if n not in listed]
    return [(n, harness.load_json("workloads", n)) for n in names]


def build(added=()) -> dict:
    accepted = cells(added)
    configs = []
    for _, w in accepted:
        if w["config"] not in [c["name"] for c in configs]:
            cfg = harness.load_json("configs", w["config"])
            configs.append({"name": w["config"], "source": cfg["source"],
                            "file": f"portbench/configs/{w['config']}.json",
                            "reduced": cfg["reduced"],
                            "why": cfg["why"]})
    workloads = [{"name": name, "config": w["config"],
                  "traffic": w["traffic"], "chips": w["chips"],
                  "why": w["why"]} for name, w in accepted]

    def reporting(kind, metric):
        return [name for name, w in accepted if metric in w[kind]]

    end_to_end, per_layer = [], []
    for kind, out in (("end_to_end", end_to_end), ("per_layer", per_layer)):
        seen = []
        for _, w in accepted:
            seen += [m for m in w[kind] if m not in seen]
        for metric in seen:
            meta = harness.load_module(
                "end_to_end" if kind == "end_to_end" else "metrics",
                metric).META
            entry = {"name": metric, "unit": meta["unit"],
                     "better": meta["better"]}
            if kind == "end_to_end":
                entry["bound"] = meta["bound"]
                entry["source"] = meta["source"]
            else:
                entry.update(source=meta["source"], layer=meta["layer"],
                             moves=meta["moves"])
            cells_of = reporting(kind, metric)
            if kind == "per_layer" or len(cells_of) < len(accepted):
                entry["workloads"] = cells_of
            out.append(entry)
    return {"command": COMMAND, "paths": PATHS, "run_seconds": RUN_SECONDS,
            "configs": configs, "workloads": workloads,
            "end_to_end": end_to_end, "per_layer": per_layer}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--add", nargs="*", default=[])
    p.add_argument("--check", action="store_true")
    args = p.parse_args(argv)
    text = json.dumps(build(args.add), indent=2) + "\n"
    path = ROOT / "BENCHMARK.json"
    if args.check:
        if not path.is_file() or path.read_text() != text:
            print("BENCHMARK.json differs from what the harness finds",
                  file=sys.stderr)
            return 1
        return 0
    path.write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
