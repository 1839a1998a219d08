"""Perf diagnostics for one dry-run cell: the counterpart of
``repro/launch/diagnose.py``, from the port's counted trace instead of
trip-weighted HLO.

    PYTHONPATH=src python -m repro_torch.launch.diagnose --arch yi-34b \\
        --shape train_4k --mesh single [--top 25]

Prints the roofline's three terms and the dominant one, the peak a device
and the useful FLOPs; the collectives by kind and by mesh axis; the top
``--top`` (module path, op) pairs by traffic (a kernel region is one op,
``kernel:<name>``); the collectives by call; and, where ``repro`` listed
its while loops and their trip counts, the totals of each layer (the
eager trace runs every layer, so there are no trip counts to show).
"""
from __future__ import annotations

import argparse
import re
import warnings
from typing import List


def _layer_key(scope: str):
    m = re.match(r"^(layers|encoder)\.(\d+)$", scope)
    return (0, m.group(1), int(m.group(2))) if m else (1, scope, 0)


def report(out: dict, counter, top: int = 25) -> List[str]:
    """The report's lines for a cell's artifact ``out`` and its counter."""
    r = out["roofline"]
    lines = [f"== {out['arch']} x {out['shape']} x {out['mesh']} "
             f"({out['chips']} chips, {out['path']}) ==",
             f"compute_s={r['compute_s']:.3f} memory_s={r['memory_s']:.3f} "
             f"collective_s={r['collective_s']:.3f} dominant={r['dominant']}",
             f"peak/dev={out['memory']['peak_per_device'] / 2**30:.2f}GiB "
             f"useful_flops={r['useful_flops_ratio']:.3f}",
             f"collectives: {r['collective_counts']}"]
    for k, v in sorted(r["collective_breakdown"].items(),
                       key=lambda kv: -kv[1]):
        if v:
            lines.append(f"  {k:20s} {v / 1e9:12.2f} GB/dev")
    for k, v in sorted(r["collective_axes"].items(), key=lambda kv: -kv[1]):
        link = "NVLink" if counter.axis_intra_node.get(k) else "network"
        lines.append(f"  axis {k:15s} {v / 1e9:12.2f} GB/dev ({link})")

    lines.append(f"\n-- top {top} traffic ops (module path, op) --")
    for nbytes, count, flops, op, path in counter.top_traffic(top):
        lines.append(f"{nbytes / 1e9:10.2f} GB x{count:<6d} "
                     f"{flops / 1e12:9.2f} TFLOP {op:28s} {path}")

    lines.append("\n-- collectives by call --")
    calls = sorted(counter.collective_calls.items(),
                   key=lambda kv: -kv[1][1])
    for (kind, axis, path), (count, nbytes) in calls[:top]:
        lines.append(f"{nbytes / 1e9:10.2f} GB x{count:<6d} {kind:16s} "
                     f"over {axis:6s} {path}")

    lines.append("\n-- per layer --")
    for scope, (flops, nbytes) in sorted(counter.scopes.items(),
                                         key=lambda kv: _layer_key(kv[0])):
        lines.append(f"  {scope:24s} {flops / 1e12:10.3f} TFLOP "
                     f"{nbytes / 1e9:10.2f} GB")
    return lines


def main() -> int:
    from repro_torch.launch.dryrun import trace_cell
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        out, counter = trace_cell(args.arch, args.shape, args.mesh,
                                  with_counter=True)
    print("\n".join(report(out, counter, args.top)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
