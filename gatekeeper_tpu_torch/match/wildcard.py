"""Prefix/suffix/contains glob (reference: pkg/wildcard/wildcard.go:17-42)."""

from __future__ import annotations


def matches(pattern: str, candidate: str) -> bool:
    if pattern.startswith("*") and pattern.endswith("*"):
        return pattern[1:-1] in candidate
    if pattern.startswith("*"):
        return candidate.endswith(pattern[1:])
    if pattern.endswith("*"):
        return candidate.startswith(pattern[:-1])
    return pattern == candidate


def matches_generate_name(pattern: str, candidate: str) -> bool:
    """generateName candidates only match contains/prefix globs
    (reference: wildcard.go:31-42)."""
    if pattern.startswith("*") and pattern.endswith("*"):
        return pattern[1:-1] in candidate
    if pattern.endswith("*"):
        return candidate.startswith(pattern[:-1])
    return False
