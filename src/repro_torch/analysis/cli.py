"""``python -m repro_torch.analysis`` — run the boundary + trace-hygiene
passes over the port's source (by default the ``repro_torch`` package
itself, wherever it is run from).

Exit status: 0 when no (unbaselined) findings, 1 otherwise. ``--strict``
ignores any baseline so only a clean tree passes; without it, findings
already recorded in ``--baseline`` are tolerated and only *new* ones fail
the run. ``--select FAMILIES`` (e.g. ``--select IF,PB``) restricts the
report to the named rule families.

``python -m repro_torch.analysis certify`` is the graph-level
information-flow certifier (IF301–IF304, ``analysis/certify.py``): it
traces every shipped method's step and proves the party boundary on the
graph (``--device cpu`` on the CPU; the card by default).
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import sys

from repro_torch.analysis import boundary, jitlint, tags
from repro_torch.analysis.findings import (
    Finding,
    apply_suppressions,
    scan_suppressions,
)

RULES = {
    "PB101": "undeclared client->server value flow",
    "PB102": "gradient-typed value flowing client-ward without a declared wire",
    "PB103": "raw client features inside server-party code",
    "PB104": "wire declaration with unknown/unmetered accounted_by target",
    "PB105": "server losses reach a ZOO estimator bypassing Transport.downlink",
    "TH201": "host sync in serve-plane hot code",
    "TH202": "Python branch on a tensor value in captured or hot code",
    "TH203": "literal-dtype cast into a captured step's carried buffer",
    "TH204": "leftover debug instrumentation",
    "BA001": "suppression comment without justification",
    "BA002": "unparseable file (syntax error)",
    "BA003": "suppression comment names an unknown rule id",
    # graph-level information-flow rules (the `certify` subcommand;
    # listed so --select and suppressions know the id space)
    "IF301": "traced: server-parameter cotangent reaches a client-bound output",
    "IF302": "traced: server->client flow bypasses the scalar wire bottleneck",
    "IF303": "traced: DP channel configured but downlink not noise-dominated",
    "IF304": "traced boundary inventory disagrees with the wire serialization",
}

KNOWN_RULES = frozenset(RULES)
# the port's package directory: the default scan
PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def iter_python_files(paths: list[str]) -> list[str]:
    out: list[str] = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(d for d in dirs if d != "__pycache__")
            for f in sorted(files):
                if f.endswith(".py"):
                    out.append(os.path.join(root, f))
    return out


def registry_accounting() -> set[str]:
    """``@tags.accounting`` qualnames from the ``ACCOUNTING_MODULES``
    registry, parsed straight from the package tree. Seeds the
    accounting set on PARTIAL scans (``python -m repro_torch.analysis
    src/repro_torch/wire``): the modules that define
    ``Transport.account_wire`` are outside such a scan, and without the
    seed every wire declaration naming them would be a spurious PB104."""
    out: set[str] = set()
    for rel in tags.ACCOUNTING_MODULES:
        path = os.path.join(PACKAGE, rel)
        if not os.path.isfile(path):
            continue
        with open(path, "r", encoding="utf-8") as fh:
            try:
                tree = ast.parse(fh.read(), filename=path)
            except SyntaxError:
                continue
        out |= boundary.collect_accounting({path: tree})
    return out


def analyze_paths(paths: list[str]) -> list[Finding]:
    """Parse every .py under ``paths`` and run both passes."""
    files = iter_python_files(paths)
    trees: dict[str, ast.Module] = {}
    sources: dict[str, str] = {}
    findings: list[Finding] = []
    for path in files:
        with open(path, "r", encoding="utf-8") as fh:
            src = fh.read()
        try:
            trees[path] = ast.parse(src, filename=path)
            sources[path] = src
        except SyntaxError as exc:
            findings.append(
                Finding("BA002", path, exc.lineno or 1, f"syntax error: {exc.msg}")
            )
    accounting = boundary.collect_accounting(trees) | registry_accounting()
    for path, tree in trees.items():
        raw = boundary.check_module(path, tree, accounting)
        raw += jitlint.check_module(path, tree)
        findings += apply_suppressions(
            raw, scan_suppressions(sources[path]), path, known_rules=KNOWN_RULES
        )
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))


def select_families(findings: list[Finding], select: str) -> list[Finding]:
    """Restrict findings to the named rule families (``"IF,PB"``).

    Raises ``SystemExit(2)`` on a family with no known rule — a typo'd
    ``--select`` must not silently report nothing."""
    known = {r.rstrip("0123456789") for r in RULES}
    wanted = [s.strip().upper() for s in select.split(",") if s.strip()]
    unknown = sorted(set(wanted) - known)
    if not wanted or unknown:
        print(
            f"--select: unknown rule family {unknown or [select]!r}; "
            f"known families: {sorted(known)}",
            file=sys.stderr,
        )
        raise SystemExit(2)
    return [f for f in findings if f.rule.rstrip("0123456789") in wanted]


def load_baseline(path: str) -> set[str]:
    with open(path, "r", encoding="utf-8") as fh:
        return set(json.load(fh))


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    if argv and argv[0] == "certify":
        # the graph-level certifier is a subcommand so the CI gate and
        # humans share one entry point; imported lazily (it traces the
        # engine, which the AST passes never import)
        from repro_torch.analysis import certify

        return certify.main(argv[1:])

    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description=__doc__,
        epilog="rules: " + ", ".join(sorted(RULES)),
    )
    parser.add_argument("paths", nargs="*", default=[PACKAGE])
    parser.add_argument(
        "--select",
        help="comma-separated rule families to report (e.g. IF,PB,TH); "
        "an unknown family exits 2",
    )
    parser.add_argument(
        "--strict",
        action="store_true",
        help="ignore the baseline: any finding fails the run",
    )
    parser.add_argument("--baseline", help="JSON baseline of tolerated finding keys")
    parser.add_argument(
        "--write-baseline",
        help="write current findings to this path as the new baseline and exit 0",
    )
    parser.add_argument("--json", action="store_true", help="machine-readable output")
    args = parser.parse_args(argv)

    findings = analyze_paths(args.paths or [PACKAGE])
    if args.select:
        findings = select_families(findings, args.select)

    if args.write_baseline:
        with open(args.write_baseline, "w", encoding="utf-8") as fh:
            json.dump(sorted(f.key() for f in findings), fh, indent=2)
        print(f"wrote {len(findings)} finding(s) to {args.write_baseline}")
        return 0

    if args.baseline and not args.strict:
        tolerated = load_baseline(args.baseline)
        findings = [f for f in findings if f.key() not in tolerated]

    if args.json:
        print(
            json.dumps(
                [dataclass_dict(f) for f in findings], indent=2, sort_keys=True
            )
        )
    else:
        for f in findings:
            print(f.render())
        if findings:
            counts: dict[str, int] = {}
            for f in findings:
                counts[f.rule] = counts.get(f.rule, 0) + 1
            summary = ", ".join(f"{r} x{n}" for r, n in sorted(counts.items()))
            print(f"\n{len(findings)} finding(s): {summary}", file=sys.stderr)
        else:
            print("analysis clean: no findings", file=sys.stderr)
    return 1 if findings else 0


def dataclass_dict(f: Finding) -> dict[str, object]:
    return {"rule": f.rule, "path": f.path, "line": f.line, "message": f.message}


if __name__ == "__main__":
    sys.exit(main())
