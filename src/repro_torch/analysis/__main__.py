"""CLI: ``python -m repro_torch.analysis [paths...] [--json FILE] [--rules ...]``
(default path: ``src/repro_torch``).

Exit status 0 when clean, 1 when any finding (or parse error) is reported —
the blocking contract the ``analyze`` CI lane relies on. ``--json`` writes
the machine-readable report CI uploads as an artifact; human output always
goes to stdout.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.analysis.core import all_rules, analyze_paths, render_human, render_json


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis", description=__doc__
    )
    ap.add_argument(
        "paths", nargs="*", default=["src/repro_torch"],
        help="files or directories (default: src/repro_torch)"
    )
    ap.add_argument("--json", metavar="FILE", help="also write a JSON report")
    ap.add_argument(
        "--rules",
        metavar="IDS",
        help="comma-separated rule subset (default: all)",
    )
    ap.add_argument(
        "--list-rules", action="store_true", help="print the rule catalog and exit"
    )
    args = ap.parse_args(argv)

    if args.list_rules:
        for rid, fn in sorted(all_rules().items()):
            doc = (fn.__doc__ or "").strip().splitlines()[0]
            print(f"{rid}  {doc}")
        return 0

    rules = args.rules.split(",") if args.rules else None
    unknown = set(rules or ()) - set(all_rules())
    if unknown:
        print(f"unknown rules: {sorted(unknown)}", file=sys.stderr)
        return 2

    findings, n_files = analyze_paths(args.paths, rules=rules)
    print(render_human(findings, n_files))
    if args.json:
        Path(args.json).write_text(render_json(findings, n_files))
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
