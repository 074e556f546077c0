"""Trips bad-suppression four ways; the unjustified one also leaves its
violation unsuppressed (a bad suppression never suppresses)."""

import os


def unjustified(tmp: str, final: str) -> None:
    # repro: allow(atomic-io)
    os.replace(tmp, final)  # stays a finding: suppression above has no why


def unknown_rule(x: int) -> int:
    # repro: allow(definitely-not-a-rule) nobody checked the rule id
    return x


def meta_rule(x: int) -> int:
    # repro: allow(bad-suppression) the exemption mechanism cannot exempt itself
    return x


def malformed(x: int) -> int:
    # repro: allow atomic-io forgot the parens
    return x
