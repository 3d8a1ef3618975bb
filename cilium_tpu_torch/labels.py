"""Label model: typed key[=value] pairs with a source prefix.

Reference: upstream cilium ``pkg/labels`` (Label, Labels, NewLabel,
ParseLabel).  Labels are the unit of identity: a workload's security
identity is the numeric ID allocated for its *sorted label set*.

A label renders as ``source:key=value`` (value optional).  Sources seen
in the reference: ``k8s``, ``reserved``, ``cidr``, ``unspec``, ``any``,
``container``.  ``any`` matches every source when used in a selector.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Iterator, Optional

SOURCE_ANY = "any"
SOURCE_K8S = "k8s"
SOURCE_RESERVED = "reserved"
SOURCE_CIDR = "cidr"
SOURCE_UNSPEC = "unspec"


@dataclass(frozen=True, order=True)
class Label:
    source: str
    key: str
    value: str = ""

    @staticmethod
    def parse(s: str) -> "Label":
        """Parse ``[source:]key[=value]`` (reference: pkg/labels ParseLabel)."""
        source = SOURCE_UNSPEC
        rest = s
        if ":" in s:
            maybe_source, after = s.split(":", 1)
            # a ':' before any '=' is a source separator
            eq = s.find("=")
            if eq == -1 or s.find(":") < eq:
                source, rest = maybe_source, after
        if "=" in rest:
            key, value = rest.split("=", 1)
        else:
            key, value = rest, ""
        return Label(source=source or SOURCE_UNSPEC, key=key, value=value)

    def matches(self, other: "Label") -> bool:
        """Does *self* (a selector label) match *other* (an endpoint label)?

        ``any`` source on the selector side matches any source.
        """
        if self.source != SOURCE_ANY and self.source != other.source:
            return False
        return self.key == other.key and self.value == other.value

    def __str__(self) -> str:
        if self.value:
            return f"{self.source}:{self.key}={self.value}"
        return f"{self.source}:{self.key}"


@dataclass(frozen=True)
class LabelSet:
    """An immutable, canonically-sorted set of labels.

    Reference: pkg/labels ``Labels`` (map) + ``SortedList`` — the sorted
    rendering is the allocator key, so two workloads with the same labels
    in any order share one identity.
    """

    labels: tuple = field(default_factory=tuple)

    def __init__(self, labels: Iterable[Label] = ()):
        object.__setattr__(self, "labels", tuple(sorted(set(labels))))

    @staticmethod
    def parse(*strs: str) -> "LabelSet":
        return LabelSet(Label.parse(s) for s in strs)

    def sorted_key(self) -> str:
        """Canonical string key (the reference's Labels.SortedList)."""
        return ";".join(str(l) for l in self.labels) + ";"

    def has(self, sel: Label) -> bool:
        return any(sel.matches(l) for l in self.labels)

    def get(self, source: str, key: str) -> Optional[Label]:
        for l in self.labels:
            if l.key == key and (source == SOURCE_ANY or l.source == source):
                return l
        return None

    def union(self, other: "LabelSet") -> "LabelSet":
        return LabelSet(self.labels + other.labels)

    def __iter__(self) -> Iterator[Label]:
        return iter(self.labels)

    def __len__(self) -> int:
        return len(self.labels)

    def __contains__(self, l: Label) -> bool:
        return l in self.labels

    def __str__(self) -> str:
        return self.sorted_key()
