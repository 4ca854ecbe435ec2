"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload <config>.<traffic> --seed <n> \
        --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the card(s) the cell asks
for. Set-up (weights from the seed on the card, the program, the traffic's
inputs, the warm-up of the cell's shapes) counts into ``setup_s``; then the
window measures for ``--seconds``; then the outputs are checked against
the plain reference. ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics, read from a profiled tail after the
window. The last stdout line is the JSON result; the compared numbers and
their limits are the last lines of stderr.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness

    harness.fixed_caches()
    c = harness.cell(args.workload)
    device = harness.require_cards(c["chips"])
    out = measure(c, args.seed, args.seconds, bool(args.trace), T_START)
    device["memory_peak_bytes"] = out["peak_bytes"]
    print("window: " + ", ".join(f"{k} {v!r}" for k, v in out["e2e"].items())
          + f", attempted {out['attempted']}, window_s {out['window_s']!r}, "
          f"check_s {out['check_s']!r}", file=sys.stderr)
    result = {"correct": all(v <= lim for _, v, lim in out["checks"]),
              "attempted": out["attempted"], "failed": out.get("failed", 0)}
    if args.trace:
        t = out["traced"]
        device["busy_s"], device["window_s"] = t["busy_s"], t["window_s"]
        run = Run(c, out)
        metrics = {}
        for m in c["per_layer"]:
            v = harness.metric_reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["metrics"] = metrics
        result["device"] = device
        top = sorted(t["families"].items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(t["idle_gaps"].items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [list(x) for x in top],
                               "idle_gaps": [list(x) for x in gaps]}
    else:
        result["metrics"] = {m["name"]: {"value": out["e2e"][m["name"]], "unit": m["unit"]}
                             for m in c["end_to_end"]}
        result["device"] = device
    harness.emit(result, out["checks"])
    return 0


def measure(c: dict, seed: int, seconds: float, trace: bool, t_start: float, **kw) -> dict:
    """One run of cell ``c`` by the runner that its traffic's ``kind`` names,
    the module ``portbench.<kind>``."""
    import importlib

    return importlib.import_module(f"portbench.{c['traffic']['kind']}").run(
        c, seed, seconds, trace, t_start, **kw)


class Run:
    """What a metric reader reads: the cell, the window's spans and counts,
    and the traced tail's summary (``trace``)."""

    def __init__(self, cell: dict, out: dict):
        self.cell, self.config, self.traffic = cell, cell["config"], cell["traffic"]
        self.out, self.spans, self.trace = out, out["spans"], out["traced"]


if __name__ == "__main__":
    sys.exit(main())
