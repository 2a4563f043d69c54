"""Fixture: a justified suppression naming a rule id that does not
exist. The AST passes find nothing wrong with the code itself — the
typo'd id is the defect (BA003): it suppresses nothing, so the finding
it meant to cover would keep firing under the real id."""


def quiet_helper(x):
    # analysis: ignore[PB999] guarding a rule id that was never minted
    return x + 1
