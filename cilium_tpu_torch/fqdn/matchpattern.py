"""toFQDNs / DNS-rule ``matchPattern`` grammar.

Reference: upstream cilium ``pkg/fqdn/matchpattern`` — ``*`` expands
to ``[-a-zA-Z0-9_]*`` (a run of DNS-label characters), so a wildcard
NEVER crosses a dot: ``*.example.com`` matches ``sub.example.com``
but NOT ``deep.sub.example.com``.  A lone ``*`` matches every name.
Names and patterns compare case-insensitively with the trailing dot
stripped (FQDN-normalized).

This closes DIVERGENCES #9 (the old fnmatch semantics spanned dots —
a security-relevant SUPERSET of the upstream matches: an operator's
rule admitted names upstream would deny).
"""

from __future__ import annotations

import re
from functools import lru_cache
from typing import Pattern

# one DNS-label character (upstream: allowedDNSCharsREGroup)
_LABEL_CHARS = "[-a-z0-9_]"


def normalize(name: str) -> str:
    """FQDN-normalize for matching: lowercase, trailing dot stripped."""
    return name.strip().rstrip(".").lower()


@lru_cache(maxsize=4096)
def to_regex(pattern: str) -> Pattern[str]:
    """Compile a matchPattern to its anchored regex."""
    pat = normalize(pattern)
    if pat == "*":
        # the match-all case: any well-formed name
        return re.compile(rf"(?:{_LABEL_CHARS}+\.)*{_LABEL_CHARS}+")
    parts = [re.escape(p) for p in pat.split("*")]
    return re.compile(f"{_LABEL_CHARS}*".join(parts))


def matches(pattern: str, name: str) -> bool:
    """Does ``name`` match ``pattern`` under the per-label grammar?"""
    return to_regex(pattern).fullmatch(normalize(name)) is not None
