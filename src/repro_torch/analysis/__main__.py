"""CLI for the static auditor: ``python -m repro_torch.analysis``.

Exit codes: 0 = clean (after baseline), 1 = unsuppressed findings,
2 = usage / stale baseline suppressions (a suppression whose finding no
longer fires must be deleted).  Runs on the CPU: the ``cuda`` impls are
traced on fake CUDA tensors and nothing is launched.
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.analysis import auditor
from repro_torch.analysis.rules import RULES
from repro_torch.analysis.source_rules import scan_cuda_source, scan_source


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static auditor for the port's op registry (precision / "
                    "capability / kernel contracts, from make_fx graphs over fake "
                    "tensors) and its Python and CUDA sources; never launches a "
                    "kernel.")
    what = p.add_mutually_exclusive_group()
    what.add_argument("--all", action="store_true",
                      help="audit every registered (family, impl, policy) triple "
                           "plus the source sweeps (default)")
    what.add_argument("--family", help="audit one op family")
    what.add_argument("--list-rules", action="store_true",
                      help="print the rule catalog and exit")
    p.add_argument("--impl", help="restrict --family to one impl")
    p.add_argument("--policy", action="append", dest="policies",
                   help="restrict to policy rung(s) (repeatable)")
    p.add_argument("--no-meshes", action="store_true",
                   help="skip the sharded (audit_meshes) traces")
    p.add_argument("--no-source", action="store_true",
                   help="skip the Python (SRC001) and CUDA (PAL003) source sweeps")
    p.add_argument("--json", action="store_true",
                   help="emit a machine-readable report on stdout")
    p.add_argument("--baseline", default=None,
                   help="suppression file (default: the package's "
                        "repro_torch/analysis/baseline.json)")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore the baseline file entirely")
    p.add_argument("--update-baseline", action="store_true",
                   help="write current findings as the new baseline")
    return p


def main(argv: list[str] | None = None) -> int:
    args = _parser().parse_args(argv)

    if args.list_rules:
        for r in RULES.values():
            print(f"{r.rule_id}  [{r.severity}]  {r.title}")
        return 0

    if args.family:
        findings = auditor.audit_family(args.family, impl=args.impl, policies=args.policies,
                                        meshes=not args.no_meshes)
        if not args.no_source:
            findings = list(findings) + scan_source() + scan_cuda_source()
    else:
        if args.impl:
            print("--impl requires --family", file=sys.stderr)
            return 2
        findings = auditor.audit_all(source=not args.no_source, meshes=not args.no_meshes)
        if args.policies:
            keep = set(args.policies)
            findings = [f for f in findings
                        if f.target.split("/")[-1].split("@")[0].split("#")[0] in keep
                        or "/" not in f.target]

    if args.update_baseline:
        path = auditor.save_baseline(args.baseline, findings)
        print(f"baseline: wrote {len(findings)} suppression(s) to {path}")
        return 0

    if args.no_baseline:
        result = auditor.apply_baseline(findings, {"suppressions": []})
    else:
        result = auditor.apply_baseline(findings, auditor.load_baseline(args.baseline))

    if args.json:
        json.dump({
            "findings": [f.as_dict() for f in result.unsuppressed],
            "suppressed": len(result.suppressed),
            "stale_suppressions": list(result.stale_keys),
        }, sys.stdout, indent=1)
        print()
    else:
        for f in result.unsuppressed:
            print(f)
        for key in result.stale_keys:
            print(f"STALE baseline suppression {key!r}: the finding no longer "
                  f"fires — delete it (or --update-baseline)")
        print(f"analysis: {len(result.unsuppressed)} finding(s), "
              f"{len(result.suppressed)} suppressed, "
              f"{len(result.stale_keys)} stale suppression(s)")

    if result.unsuppressed:
        return 1
    if result.stale_keys:
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
