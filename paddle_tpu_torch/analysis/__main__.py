"""``python -m paddle_tpu_torch.analysis`` — run graftlint over the port
from the shell.

Exit status 0 when every finding is suppressed/baselined, 1 otherwise
(2 on usage errors), so the module drops straight into CI.
"""

from __future__ import annotations

import argparse
import json
import sys

from .astlint import all_rules, run


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.analysis",
        description="graftlint for the port: static analysis for host "
                    "syncs in captured code, determinism discipline, "
                    "serving invariants and the port's isolation")
    parser.add_argument("paths", nargs="*",
                        help="files/dirs relative to the repo root "
                             "(default: the paddle_tpu_torch package)")
    parser.add_argument("--format", choices=("text", "json"),
                        default="text")
    parser.add_argument("--rule", action="append", dest="rules",
                        metavar="NAME",
                        help="run only this rule (repeatable)")
    parser.add_argument("--root", default=None,
                        help="repo root (default: auto-detected)")
    parser.add_argument("--list-rules", action="store_true")
    parser.add_argument("--show-suppressed", action="store_true",
                        help="also print suppressed/baselined findings")
    args = parser.parse_args(argv)

    if args.list_rules:
        for name, cls in sorted(all_rules().items()):
            print(f"{name}: {cls.description}")
        return 0

    try:
        findings = run(root=args.root, paths=args.paths or None,
                       rules=args.rules)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    active = [f for f in findings if f.active]
    shown = findings if args.show_suppressed else active
    if args.format == "json":
        print(json.dumps({
            "findings": [f.to_dict() for f in shown],
            "counts": {
                "active": len(active),
                "suppressed": sum(f.suppressed for f in findings),
                "baselined": sum(f.baselined for f in findings),
            },
        }, indent=2, sort_keys=True))
    else:
        for f in shown:
            tag = ""
            if f.suppressed:
                tag = "  [suppressed]"
            elif f.baselined:
                tag = "  [baselined]"
            print(f.format() + tag)
        print(f"graftlint: {len(active)} finding(s) "
              f"({sum(f.suppressed for f in findings)} suppressed, "
              f"{sum(f.baselined for f in findings)} baselined)")
    return 1 if active else 0


if __name__ == "__main__":
    sys.exit(main())
