"""Shared column-spec table rendering for the launch CLIs.

A copy of ``repro.obs.format``.  A CLI declares its columns as
:class:`Column` specs over its report rows (plain dicts) and calls
:func:`render_table`, so a metric added to the rows (``run_compare``'s)
appears in the table by adding one spec entry.

A :class:`Column` maps a row key to a fixed-width cell:

  ``Column("modeled_dpu_seconds", "dpu_s", width=10, spec="10.3e")``

``spec`` is a ``format()`` mini-language string applied when the value
is present; missing keys render as ``default`` (``"-"``).  ``extra`` on
:func:`render_table` appends a free-form suffix per row (error strings,
ratio notes) outside the column grid.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable, List, Optional, Sequence


@dataclass(frozen=True)
class Column:
    """One table column: row ``key`` -> fixed-width formatted cell."""

    key: str
    header: Optional[str] = None
    width: int = 10
    spec: str = "s"                  # format() spec for present values
    align: str = ">"                 # header/missing-value alignment
    default: str = "-"

    @property
    def title(self) -> str:
        return self.header if self.header is not None else self.key

    def cell(self, row: dict) -> str:
        value = row.get(self.key)
        if value is None:
            text = self.default
        else:
            try:
                text = format(value, self.spec)
            except (TypeError, ValueError):
                text = str(value)
        if len(text) > self.width:
            # left-truncate numbers never; clip long labels from the right
            text = text[: self.width]
        return f"{text:{self.align}{self.width}}"

    def head(self) -> str:
        return f"{self.title[: self.width]:{self.align}{self.width}}"


def render_table(rows: Iterable[dict], columns: Sequence[Column],
                 extra: Optional[Callable[[dict], str]] = None,
                 rule: bool = False) -> str:
    """Render ``rows`` under a header line; one string, no trailing \\n.

    ``extra(row)`` may return a suffix appended after the last column
    (empty string for none); ``rule=True`` draws a dash rule under the
    header."""
    lines: List[str] = [" ".join(c.head() for c in columns)]
    if rule:
        lines.append("-" * len(lines[0]))
    for row in rows:
        line = " ".join(c.cell(row) for c in columns)
        if extra is not None:
            suffix = extra(row)
            if suffix:
                line = f"{line}  {suffix}"
        lines.append(line)
    return "\n".join(lines)


def format_bytes(n: int) -> str:
    """Thousands-separated byte count (``1,234,567 B``)."""
    return f"{n:,} B"


def format_ratio(value: Optional[float]) -> str:
    """Drift/speedup ratio with sensible sig-figs; ``-`` when absent."""
    if value is None:
        return "-"
    if value >= 100:
        return f"{value:.0f}x"
    return f"{value:.2f}x"
