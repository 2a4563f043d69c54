"""Finding record + inline-suppression handling shared by both passes."""

from __future__ import annotations

import dataclasses
import re

# ``# analysis: ignore[PB101] reason...`` — reason is mandatory (BA001).
_SUPPRESS_RE = re.compile(
    r"#\s*analysis:\s*ignore\[(?P<rules>[A-Z]{2}\d{3}(?:\s*,\s*[A-Z]{2}\d{3})*)\]"
    r"(?P<reason>.*)$"
)


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    message: str

    def key(self) -> str:
        """Stable identity for baseline matching (line numbers drift)."""
        return f"{self.rule}:{self.path}:{self.message}"

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


@dataclasses.dataclass(frozen=True)
class Suppression:
    line: int
    rules: tuple[str, ...]
    reason: str


def scan_suppressions(source: str) -> list[Suppression]:
    out = []
    for i, text in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(text)
        if m is not None:
            rules = tuple(r.strip() for r in m.group("rules").split(","))
            out.append(Suppression(i, rules, m.group("reason").strip()))
    return out


def apply_suppressions(
    findings: list[Finding],
    suppressions: list[Suppression],
    path: str,
    known_rules: frozenset[str] | None = None,
) -> list[Finding]:
    """Drop findings covered by a justified inline suppression.

    A suppression on line N covers findings on lines N and N+1 (comment
    above the offending statement or trailing on the same line). An
    unjustified suppression (empty reason) is converted into a BA001
    finding instead of taking effect. When ``known_rules`` is given, a
    suppression naming a rule id outside it is a BA003 finding and that
    id suppresses nothing (a typo like ``ignore[PB110]`` would otherwise
    silently rot while the finding it meant to cover keeps firing under
    a different id).
    """
    kept: list[Finding] = []
    for sup in suppressions:
        if not sup.reason:
            kept.append(
                Finding(
                    "BA001",
                    path,
                    sup.line,
                    "suppression without justification: every "
                    "`# analysis: ignore[...]` must carry a reason",
                )
            )
        if known_rules is not None:
            for rule in sup.rules:
                if rule not in known_rules:
                    kept.append(
                        Finding(
                            "BA003",
                            path,
                            sup.line,
                            f"suppression names unknown rule id {rule!r}; "
                            "it suppresses nothing (known rules: see "
                            "`python -m repro.analysis --help`)",
                        )
                    )
    covered = {
        (line, rule)
        for sup in suppressions
        if sup.reason
        for rule in sup.rules
        if known_rules is None or rule in known_rules
        for line in (sup.line, sup.line + 1)
    }
    for f in findings:
        if (f.line, f.rule) not in covered:
            kept.append(f)
    return sorted(kept, key=lambda f: (f.path, f.line, f.rule))
