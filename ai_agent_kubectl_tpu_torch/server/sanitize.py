"""Query sanitation (reference app.py:60-68)."""

from __future__ import annotations


def sanitize_query(query: str) -> str:
    """Normalize a multi-line query to a single line with collapsed whitespace.

    Same contract as the reference's ``sanitize_query`` (app.py:60-68):
    newlines/CRs/tabs become spaces, runs of whitespace collapse to one
    space, and the result is stripped.
    """
    normalized = query.replace("\n", " ").replace("\r", " ").replace("\t", " ")
    return " ".join(normalized.split()).strip()
