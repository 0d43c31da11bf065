"""CI smoke: load an exported trace + waste breakdown back and re-assert
the invariants the telemetry promises.

    python -m repro_torch.obs.check trace.json breakdown.json

  * the trace passes ``validate_trace`` (schema, sorted non-overlapping
    spans per track, balanced async begin/end);
  * for every row of the breakdown, the per-cause waste totals sum to
    the engine's independently-accumulated total within float tolerance.

Exit status 1 with a message per violation; 0 and a one-line OK
otherwise. This runs in CI against the artifacts the benchmark sweep
uploads, so a regression in either exporter fails the build even if no
unit test covers the exact workload.
"""
from __future__ import annotations

import json
import sys

from repro_torch.obs.export import validate_trace

REL_TOL = 1e-6


def check_breakdown(obj) -> list:
    """Validate one breakdown dict or a list/dict of them."""
    errors = []
    if isinstance(obj, dict) and "causes" not in obj:
        rows = list(obj.items())            # {name: report, ...}
    elif isinstance(obj, list):
        rows = [(str(i), r) for i, r in enumerate(obj)]
    else:
        rows = [("report", obj)]
    for name, row in rows:
        causes = row.get("causes")
        if not isinstance(causes, dict):
            errors.append(f"{name}: missing causes dict")
            continue
        total = sum(causes.values())
        check = row.get("total_waste_check", row.get("total_waste"))
        if check is None:
            errors.append(f"{name}: missing total_waste_check")
            continue
        scale = max(abs(total), abs(check), 1.0)
        if abs(total - check) > REL_TOL * scale:
            errors.append(
                f"{name}: sum(causes)={total!r} != "
                f"total_waste_check={check!r}")
    return errors


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: python -m repro_torch.obs.check "
              "[trace.json ...] [breakdown.json ...]", file=sys.stderr)
        return 2
    errors = []
    for path in argv:
        with open(path) as f:
            obj = json.load(f)
        if isinstance(obj, dict) and "traceEvents" in obj:
            errs = validate_trace(obj)
            print(f"{path}: trace, {len(obj['traceEvents'])} events, "
                  f"{len(errs)} errors")
        else:
            errs = check_breakdown(obj)
            print(f"{path}: breakdown, {len(errs)} errors")
        errors += [f"{path}: {e}" for e in errs]
    for e in errors:
        print("ERROR " + e, file=sys.stderr)
    if not errors:
        print("obs.check OK")
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
