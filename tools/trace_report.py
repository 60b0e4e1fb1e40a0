#!/usr/bin/env python3
"""Per-op breakdown of a jax.profiler trace of ``steps`` scanned steps.

Reads the newest ``*trace.json.gz`` under ``trace_dir`` (written by
``jax.profiler.trace(trace_dir, create_perfetto_trace=True)``), keeps the
events of the GPU device planes (processes named ``/device:GPU:<n>``), sums
their durations per op and prints us/step per op.

Usage: python tools/trace_report.py trace_dir [steps]
"""
import collections
import glob
import gzip
import json
import os
import sys


def load_device_events(trace_dir):
    paths = sorted(glob.glob(os.path.join(
        trace_dir, "plugins/profile/*/*trace.json.gz")))
    if not paths:
        raise SystemExit(f"no trace.json.gz under {trace_dir}")
    path = paths[-1]
    with gzip.open(path) as f:
        tr = json.load(f)
    ev = tr["traceEvents"]
    dev_pids = {e["pid"] for e in ev
                if e.get("ph") == "M" and e.get("name") == "process_name"
                and "/device:GPU" in str(e.get("args", {}).get("name", ""))}
    return path, [e for e in ev
                  if e.get("ph") == "X" and e.get("pid") in dev_pids]


def main():
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    trace_dir = sys.argv[1]
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 50
    path, ev = load_device_events(trace_dir)
    print(f"# {path}: {len(ev)} device events", flush=True)
    tot, num = collections.Counter(), collections.Counter()
    for e in ev:
        tot[e["name"]] += e["dur"]
        num[e["name"]] += 1
    span = (max(e["ts"] + e["dur"] for e in ev)
            - min(e["ts"] for e in ev))
    print(f"device span {span / 1e3:.3f} ms = {span / steps:.1f} us/step "
          f"({steps} steps)")
    print(f"{'us/step':>9}  {'calls/step':>10}  op")
    for name, d in tot.most_common():
        if name.startswith("jit_") or name == "while":
            continue  # enclosing regions double-count their children
        if d / steps < 0.25:
            continue
        print(f"{d / steps:9.2f}  {num[name] / steps:10.2f}  {name[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
