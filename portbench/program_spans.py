"""What the readers of the program's own spans share. A traced tick keeps
its span split (``fleet_feed.span_split``: the ms of every span
below the tick, summed by its path of names); a reader takes the spans
whose path ends in a given name, so it finds them wherever the program
nests them."""

from __future__ import annotations


def ends_in(path: str, name: str) -> bool:
    return path == name or path.endswith("/" + name)


def tick_mean(ticks, name: str) -> float | None:
    """Mean over the ticks that keep a span split of the ms a tick spent
    in spans named ``name``, summed; None when no tick has one (a program
    that does not record the span)."""
    split = [t["spans"] for t in ticks if "spans" in t]
    if not any(ends_in(p, name) for spans in split for p in spans):
        return None
    return sum(ms for spans in split for p, ms in spans.items()
               if ends_in(p, name)) / len(split)
